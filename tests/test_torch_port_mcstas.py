"""The port's McStas instrument (`data/mcstas.py`) and `McStasRenderer`
against the JAX package's: the declarative dif60 spec field by field, and
materialization and the sweep through the same mock mcstasscript backend as
tests/test_mcstas.py (no simulator is needed). Everything here is exact."""

import dataclasses

import numpy as np
import pytest

import swinwnet_tpu.data.generation as jgen
import swinwnet_tpu.data.mcstas as jmc
import swinwnet_tpu_torch.data.generation as pgen
import swinwnet_tpu_torch.data.mcstas as pmc
from test_mcstas import FakeBackend


def as_data(spec):
    return dataclasses.asdict(spec)


@pytest.mark.parametrize("crystal,us", [('"Si.laz"', 150.0), ('"Al.laz"', 10.0), ('"Na2Ca3Al2F14.laz"', 300.0)])
def test_spec_equals_jax_field_by_field(crystal, us):
    got, want = pmc.dif60_spec(crystal, us), jmc.dif60_spec(crystal, us)
    assert as_data(got) == as_data(want)
    assert [c.name for c in got.components] == [
        "origin", "source", "Ch1", "Ch11", "monitor_ndt_ch11", "guide", "bender",
        "Mon_source_lambda", "Arm_sample", "powdern", "Detector"]
    assert got.detector_component == "Detector"
    assert (pmc.MODERATOR, pmc.SOURCE_FREQ_HZ, pmc.SOURCE_PULSE_NUMBER) == (
        jmc.MODERATOR, jmc.SOURCE_FREQ_HZ, jmc.SOURCE_PULSE_NUMBER)


def test_spec_is_frozen():
    spec = pmc.dif60_spec('"Si.laz"', 50.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.name = "other"


def materialized(module, spec):
    instr = module.materialize(spec, FakeBackend, mcrun_path="mcstas/bin/mcrun", mcstas_path="mcstas")
    return (instr.name, instr.declares, instr.initialize,
            [(c._name, c._type, c._extend, c._at, c._rotated,
              {k: v for k, v in vars(c).items() if not k.startswith("_")}) for c in instr.components])


def test_materialize_through_the_mock_backend():
    got = materialized(pmc, pmc.dif60_spec('"Si.laz"', 100.0))
    want = materialized(jmc, jmc.dif60_spec('"Si.laz"', 100.0))
    assert got == want
    assert len(got[3]) == 11 and got[3][1][3] == (("0", "0", "0"), "origin")
    assert got[3][9][4] == (("0", " 0", " 0"), "PREVIOUS")


def test_run_returns_detector_intensity():
    img = pmc.run_instrument(pmc.dif60_spec('"Si.laz"', 100.0), FakeBackend, ncount=2e7)
    assert FakeBackend.last_instr.ncount == 2e7
    np.testing.assert_array_equal(img, jmc.run_instrument(jmc.dif60_spec('"Si.laz"', 100.0), FakeBackend, ncount=2e7))
    assert img.shape == (250, 480)


def test_renderer_and_sweep():
    assert pgen.SWEEP_STATS == jgen.SWEEP_STATS
    assert pgen.SWEEP_PULSE_DURATIONS_US == jgen.SWEEP_PULSE_DURATIONS_US
    got = pgen.McStasRenderer(backend=FakeBackend).render_sweep(['"Si.laz"', '"Rb.laz"'], stats=pgen.SWEEP_STATS[:2],
                                                                 pulses=(10.0, 20.0))
    want = jgen.McStasRenderer(backend=FakeBackend).render_sweep(['"Si.laz"', '"Rb.laz"'], stats=jgen.SWEEP_STATS[:2],
                                                                  pulses=(10.0, 20.0))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert set(g) == {"Matrix", "Crystal", "Stats", "Pulce duration"}
        assert (g["Crystal"], g["Stats"], g["Pulce duration"]) == (w["Crystal"], w["Stats"], w["Pulce duration"])
        np.testing.assert_array_equal(g["Matrix"], w["Matrix"])


def test_missing_backend_raises_importerror():
    with pytest.raises(ImportError, match="synthesize_pattern"):
        pgen.McStasRenderer()  # mcstasscript is not installed
