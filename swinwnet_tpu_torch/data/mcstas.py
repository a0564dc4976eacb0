"""McStas TOF-diffractometer instrument (a copy of
`swinwnet_tpu/data/mcstas.py`, numpy only; reference L0:
support_files/Diffraction_generation_script.py:18-264).

Re-designed as *spec-as-data*: `dif60_spec()` builds a declarative
`InstrumentSpec` — declares, initialize lines, and an ordered component list
(3-component moderator `Source_gen`, double `DiskChopper` pair, 5.5 m
`Guide_gravity`, 12-channel `Bender`, `PowderN` powder sample from a `.laz`
reflection list, 480x250 banana `Monitor_nD`) — which unit tests can inspect
without any simulator. `materialize()` is the only code that touches
mcstasscript, and it takes the backend module as an argument so tests inject a
mock while production passes the real `mcstasscript` package.

The beamline layout (positions/parameters) reproduces the published
instrument exactly; the rendered detector intensity is the `[250, 480]`
pattern consumed by the rest of the framework.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ComponentSpec:
    """One beamline component: type, parameters, placement."""

    name: str
    type: str
    params: Dict[str, Any] = field(default_factory=dict)
    at: Tuple[str, str, str] = ("0", "0", "0")
    relative: str = "ABSOLUTE"
    rotated: Optional[Tuple[str, str, str]] = None
    rotated_relative: Optional[str] = None
    extend: Tuple[str, ...] = ()


@dataclass(frozen=True)
class InstrumentSpec:
    name: str
    declares: Tuple[Tuple[str, str, Optional[float]], ...]  # (ctype, name, value)
    initialize: Tuple[str, ...]
    components: Tuple[ComponentSpec, ...]
    detector_component: str


# Moderator spectrum: three Maxwellian components (T_i, I_i) of the pulsed
# source; intensities are rescaled at initialize time by the duty factor
# pulse_length[us] * 1e-6 * source_freq (Diffraction_generation_script.py:38-52).
MODERATOR = dict(T1=98.3, I1=2.64e11, T2=303.1, I2=1.19e11, T3=29.9, I3=3.10e11)
SOURCE_FREQ_HZ = 60.0
SOURCE_PULSE_NUMBER = 2.0


def dif60_spec(crystal: str, pulse_duration_us: float) -> InstrumentSpec:
    """The dif60 TOF diffractometer with a `crystal` (.laz reflection list)
    powder sample and the given moderator pulse length in microseconds."""
    declares = (
        ("double", "T1", MODERATOR["T1"]),
        ("double", "I1", MODERATOR["I1"]),
        ("double", "T2", MODERATOR["T2"]),
        ("double", "I2", MODERATOR["I2"]),
        ("double", "T3", MODERATOR["T3"]),
        ("double", "I3", MODERATOR["I3"]),
        ("double", "T", None),
        ("double", "t", None),
        ("double", "source_freq", SOURCE_FREQ_HZ),
        ("double", "source_pulse_number", SOURCE_PULSE_NUMBER),
        ("double", "pulse_length", float(pulse_duration_us)),
    )
    initialize = tuple(
        f"I{i} = I{i} * pulse_length * 1e-6 * source_freq; " for i in (1, 2, 3)
    )

    components = (
        ComponentSpec("origin", "Progress_bar", at=("0", " 0", " 0")),
        ComponentSpec(
            "source",
            "Source_gen",
            params=dict(
                dist=0.1,
                focus_xw=0.03,
                focus_yh=0.03,
                lambda0=5.0,
                dlambda=4.9,
                I1="I1",
                yheight=0.04,
                xwidth=0.04,
                T1="T1",
                T2="T2",
                I2="I2",
                T3="T3",
                I3="I3",
            ),
            at=("0", "0", "0"),
            relative="origin",
            # multi-pulse time structure: each neutron is stamped into one of
            # `source_pulse_number` frames with a uniform intra-pulse offset
            extend=(
                "T = floor(rand01()*source_pulse_number);",
                "t = rand01()*pulse_length*1e-6 + T*1/source_freq;",
            ),
        ),
        ComponentSpec(
            "Ch1",
            "DiskChopper",
            params=dict(
                theta_0=8, radius=0.75, yheight=0, nu=60, nslit=1,
                delay="0.000175/2", isfirst=0,
            ),
            at=("0", "0", "0.101"),
            relative="source",
        ),
        ComponentSpec(
            "Ch11",
            "DiskChopper",
            params=dict(
                theta_0=8, radius=0.75, yheight=0, nu=-60, nslit=1,
                delay="0.000175/2", isfirst=0,
            ),
            at=("0", "0", "1e-6"),
            relative="PREVIOUS",
        ),
        ComponentSpec(
            "monitor_ndt_ch11",
            "Monitor_nD",
            params=dict(
                xwidth=0.1,
                yheight=0.1,
                restore_neutron=1,
                options='"t limits =[-0.00001 0.2] bins = 600"',
            ),
            at=("0", " 0", "1e-5"),
            relative="Ch1",
        ),
        ComponentSpec(
            "guide",
            "Guide_gravity",
            params=dict(w1=0.03, h1=0.03, w2=0.03, h2=0.03, l=5.5, m=2.5),
            at=("0", "0", "0.01"),
            relative="PREVIOUS",
        ),
        ComponentSpec(
            "bender",
            "Bender",
            params=dict(w=0.03, h=0.03, r=870, k=2, l=12, ma=2.5, mi=2.5, ms=2.5),
            at=("0", "0", "5.51"),
            relative="PREVIOUS",
        ),
        ComponentSpec(
            "Mon_source_lambda",
            "L_monitor",
            params=dict(nL=250, xwidth=0.1, yheight=0.1, Lmin=0, Lmax=15, restore_neutron=1),
            at=("0", "0", "12.01"),
            relative="PREVIOUS",
        ),
        ComponentSpec("Arm_sample", "Arm", at=("0", " 0", " 1.05"), relative="PREVIOUS"),
        ComponentSpec(
            "powdern",
            "PowderN",
            params=dict(reflections=crystal, radius=0.05, yheight=0.1),
            at=("0", " 0", " 0"),
            relative="Arm_sample",
            rotated=("0", " 0", " 0"),
            rotated_relative="PREVIOUS",
        ),
        ComponentSpec(
            "Detector",
            "Monitor_nD",
            params=dict(
                yheight=0.5,
                radius=0.5,
                options='"banana theta limits = [-170 170] bins = 480 lambda limits = [0.1 10]] bins 250"',
            ),
            at=("0", " 0", " 0"),
            relative="Arm_sample",
        ),
    )
    return InstrumentSpec(
        name="Diffraction_imshow",
        declares=declares,
        initialize=initialize,
        components=components,
        detector_component="Detector",
    )


def materialize(spec: InstrumentSpec, backend, mcrun_path: str = "", mcstas_path: str = ""):
    """Build a backend (mcstasscript-compatible) instrument from a spec.

    `backend` is the mcstasscript module (or a test double exposing
    `Configurator`, `McStas_instr`, `name_search`).
    """
    cfg = backend.Configurator()
    if mcrun_path:
        cfg.set_mcrun_path(mcrun_path)
    if mcstas_path:
        cfg.set_mcstas_path(mcstas_path)

    instr = backend.McStas_instr(spec.name)
    for ctype, name, value in spec.declares:
        if value is None:
            instr.add_declare_var(ctype, name)
        else:
            instr.add_declare_var(ctype, name, value=value)
    for line in spec.initialize:
        instr.append_initialize(line)

    for comp in spec.components:
        obj = instr.add_component(comp.name, comp.type)
        for key, val in comp.params.items():
            setattr(obj, key, val)
        for line in comp.extend:
            obj.append_EXTEND(line)
        obj.set_AT(list(comp.at), RELATIVE=comp.relative)
        if comp.rotated is not None:
            obj.set_ROTATED(list(comp.rotated), RELATIVE=comp.rotated_relative)
    return instr


def run_instrument(spec: InstrumentSpec, backend, ncount: float,
                   mcrun_path: str = "", mcstas_path: str = "") -> np.ndarray:
    """Materialize, simulate, and extract the detector intensity [250, 480]."""
    instr = materialize(spec, backend, mcrun_path, mcstas_path)
    instr.settings(ncount=ncount)
    instr.set_parameters()
    data = instr.backengine()
    detector = backend.name_search(spec.detector_component, data)
    return np.asarray(detector.Intensity)
