"""The port's viewer CLI against the JAX package's (`apps/viewer.py`): the
same `.pth` (the port's seeded `state_dict()`, which the JAX
`load_model_any` reads through `convert_state_dict`) and the same
`synthesize_pattern` `.npy` go through `python -m swinwnet_tpu.apps.viewer`'s
`main` and `python -m swinwnet_tpu_torch.apps.viewer --device cpu`.

Tolerances: the 8 stage arrays within 1e-5 of each stage's max (the serving
pipeline agrees to ~1e-6 of its max on the CPU: fp32 sums in other orders);
the two I(d) CSVs with the same header, each column within 1e-5 of its max
(the rebin sums up to a few hundred fp32 pixels a bin, in another order
than XLA's segment_sum)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swinwnet_tpu_torch.apps import viewer as port_viewer
from swinwnet_tpu_torch.data import synthesize_pattern
from swinwnet_tpu_torch.models import SwinWNet

REPO = Path(__file__).resolve().parents[1]
STAGES = ("images", "seg_map_lr", "images_masked_lr", "norm", "upscaled_norm", "upscaled_denorm",
          "seg_map_hr", "images_masked_hr")
CSVS = ("input_id_curves.csv", "masked_hr_id_curves.csv")
TOL = 1e-5
PUBLISHED = dict(in_chans=1, embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=5,
                 patch_size=2)


def published_model(seed=0, error_matrix=True):
    """The published SwinWNet on the CPU, weights from `seed`, the
    cross-attention gammas at 0.5 so that those blocks are live."""
    model = SwinWNet(**PUBLISHED, error_matrix=error_matrix, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for ca in (model.ca_seg_to_sr, model.ca_sr_to_seg):
            for blk in ca.blocks:
                blk.gamma.fill_(0.5)
    return model


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    torch.set_num_threads(1)  # see the one_thread fixture of tests/test_torch_port_gui_models.py
    d = tmp_path_factory.mktemp("viewer")
    model = published_model()
    pth = d / "m.pth"
    torch.save(model.state_dict(), pth)
    npy = d / "p.npy"
    np.save(npy, synthesize_pattern([1.5, 3.0, 5.2], [1.0, 0.7, 0.4], H=50, W=60, seed=1))
    return d, str(pth), str(npy), model


@pytest.fixture(scope="module")
def jax_out(files):
    """The JAX CLI's output directory (its persistent compile cache off)."""
    from swinwnet_tpu.apps import viewer as jax_viewer

    d, pth, npy, _ = files
    out = d / "jax"
    saved = os.environ.get("SWINWNET_COMPILE_CACHE")
    os.environ["SWINWNET_COMPILE_CACHE"] = "0"
    try:
        jax_viewer.main(["--weights", pth, "--input", npy, "--out", str(out)])
    finally:
        if saved is None:
            os.environ.pop("SWINWNET_COMPILE_CACHE")
        else:
            os.environ["SWINWNET_COMPILE_CACHE"] = saved
    return out


def read_csv(path):
    with open(path) as f:
        header = f.readline().strip()
    return header, np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def assert_outputs_agree(got_dir, want_dir):
    for name in STAGES:
        got, want = np.load(got_dir / f"{name}.npy"), np.load(want_dir / f"{name}.npy")
        assert got.shape == want.shape and got.dtype == np.float32, name
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
        assert err <= TOL, f"{name}: {err:.2e} of its max"
    for name in CSVS:
        (h_got, got), (h_want, want) = read_csv(got_dir / name), read_csv(want_dir / name)
        assert h_got == h_want == "d,I_0", name
        assert got.shape == want.shape, name
        err = np.abs(got - want).max(axis=0) / np.maximum(np.abs(want).max(axis=0), 1e-12)
        assert (err <= TOL).all(), f"{name}: {err}"


def test_cli_module_on_cpu_matches_jax_cli(files, jax_out):
    d, pth, npy, _ = files
    out = d / "port_cli"
    res = subprocess.run(
        [sys.executable, "-m", "swinwnet_tpu_torch.apps.viewer", "--weights", pth, "--input", npy,
         "--out", str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stderr
    assert "error_matrix=True" in res.stdout and "wrote 8 stage arrays" in res.stdout
    assert sorted(os.listdir(out)) == sorted([f"{s}.npy" for s in STAGES] + list(CSVS))
    assert_outputs_agree(out, jax_out)


def test_split_matches_jax_cli(files, jax_out):
    d, pth, npy, _ = files
    out = d / "port_split"
    port_viewer.main(["--weights", pth, "--input", npy, "--out", str(out), "--device", "cpu", "--split"])
    assert_outputs_agree(out, jax_out)
    single = d / "port_single"
    port_viewer.main(["--weights", pth, "--input", npy, "--out", str(single), "--device", "cpu"])
    for name in STAGES:  # the same operations: the same bits
        np.testing.assert_array_equal(np.load(out / f"{name}.npy"), np.load(single / f"{name}.npy"))


@pytest.mark.parametrize("form", ["raw", "wrapped_module_prefix", "model_state_dict", "pickled_module"])
def test_load_model_any_payload_forms(files, tmp_path, form):
    _, _, _, model = files
    sd = model.state_dict()
    payload = {
        "raw": sd,
        "wrapped_module_prefix": {"state_dict": {"module." + k: v for k, v in sd.items()}},
        "model_state_dict": {"model_state_dict": sd, "epoch": 3},
        "pickled_module": model,
    }[form]
    path = tmp_path / "w.pth"
    torch.save(payload, path)
    loaded, error_matrix = port_viewer.load_model_any(str(path), device="cpu")
    assert error_matrix is True and not loaded.training
    assert loaded.patch_embed.proj.weight.device.type == "cpu"
    got = loaded.state_dict()
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_load_model_any_sniffs_a_single_modality_checkpoint(tmp_path):
    path = tmp_path / "single.pth"
    torch.save(published_model(seed=2, error_matrix=False).state_dict(), path)
    model, error_matrix = port_viewer.load_model_any(str(path), device="cpu")
    assert error_matrix is False and model.patch_embed.proj.weight.shape[1] == 1


def test_export_stage_csv_rejects_empty_and_names_columns(tmp_path):
    with pytest.raises(ValueError, match="no curves"):
        port_viewer.export_stage_csv(str(tmp_path / "x.csv"), [])
    curves = [{"d": np.array([1.0, 2.0]), "I": np.array([3.0, 4.0])},
              {"d": np.array([1.0, 2.0]), "I": np.array([5.0, 6.0])}]
    path = tmp_path / "c.csv"
    port_viewer.export_stage_csv(str(path), curves, sample_names=["a", "b"])
    assert path.read_text().splitlines() == ["d,a,b", "1.0,3.0,5.0", "2.0,4.0,6.0"]


def test_cli_defaults_to_the_card(files, monkeypatch, tmp_path):
    """Without --device the CLI asks for CUDA, and with no card it raises
    rather than fall back to the CPU."""
    _, pth, npy, _ = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_viewer.main(["--weights", pth, "--input", npy, "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
