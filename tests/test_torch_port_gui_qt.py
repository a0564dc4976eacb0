"""The port's Qt shells (`apps/gui.py`). The module imports without
PySide6, and its entry points then raise an ImportError that names PySide6
and the headless CLI. Where PySide6 is installed, the offscreen smoke tests
of tests/test_gui_qt.py run on the port's windows (the viewer's state model
on the CPU); without it they skip."""

import importlib.util
import os

import numpy as np
import pytest

from swinwnet_tpu_torch.apps import gui
from swinwnet_tpu_torch.data import synthesize_pattern

HAVE_QT = importlib.util.find_spec("PySide6") is not None


@pytest.mark.skipif(HAVE_QT, reason="PySide6 is installed: the smoke tests below run instead")
@pytest.mark.parametrize("entry", ["build_viewer_window", "build_labeler_window", "run_viewer", "run_labeler"])
def test_entry_points_name_pyside6_and_the_headless_cli(entry):
    with pytest.raises(ImportError, match="PySide6") as info:
        getattr(gui, entry)()
    assert "python -m swinwnet_tpu_torch.apps.viewer" in str(info.value)


@pytest.mark.skipif(HAVE_QT, reason="PySide6 is installed: the smoke tests below run instead")
def test_main_dispatches_to_the_apps():
    for argv in ([], ["viewer"], ["labeler"]):
        with pytest.raises(ImportError, match="PySide6"):
            gui.main(argv)
    with pytest.raises(SystemExit, match="unknown app"):
        gui.main(["other"])


@pytest.fixture(scope="module")
def qapp():
    pytest.importorskip("PySide6")
    os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")
    from PySide6.QtWidgets import QApplication

    yield QApplication.instance() or QApplication([])


def test_viewer_window_smoke(qapp, tmp_path):
    win, model = gui.build_viewer_window()
    model.device = "cpu"
    win.resize(1200, 800)
    win.show()
    payload = {
        "images": np.stack([synthesize_pattern([1.5, 3.0], [1.0, 0.7], H=50, W=60, seed=i) for i in range(2)])[:, None],
        "seg_map_lr": np.random.default_rng(0).uniform(0, 1, (2, 1, 50, 60)).astype(np.float32),
    }
    p = str(tmp_path / "stages.npy")
    np.save(p, payload, allow_pickle=True)
    win.load_npy(p)
    assert model.stage_order == ["images", "seg_map_lr"]
    win._stage_buttons["images"].setChecked(True)
    win._stage_buttons["seg_map_lr"].setChecked(True)
    qapp.processEvents()
    assert model.selected_stages == ["images", "seg_map_lr"]
    assert win.tiles_grid.count() >= 2
    win.chk_norm1d.setChecked(True)
    qapp.processEvents()
    assert model.norm_1d is True
    win.spin_dn.setValue(333)
    win.apply_d_grid()
    assert model.fixed_centers.size == 333
    out = str(tmp_path / "curves.csv")
    win._file_dialog = type("FD", (), {"getSaveFileName": staticmethod(lambda *a, **k: (out, ""))})
    win.export_csv()
    assert os.path.exists(out)
    win.close()


def test_labeler_window_smoke(qapp, tmp_path):
    win, model = gui.build_labeler_window()
    model.device = "cpu"
    win.show()
    imgs = np.stack([synthesize_pattern([1.2, 2.5], [2.0, 1.0], H=50, W=60, seed=i) for i in range(2)])
    p = str(tmp_path / "diff.npy")
    np.save(p, imgs)
    win.load_npy(p)
    assert model.diffractions.shape == (2, 50, 60)
    win._on_span(2.45, 2.55)
    win._on_span(1.0, 1.2)

    class FakeEvent:
        inaxes = win.canvas.ax_prof
        button = 3

    win._on_click(FakeEvent())
    assert model.intervals[0] == [(2.45, 2.55)]
    win.next_item()
    out = str(tmp_path / "masks.npy")
    win._file_dialog = type("FD", (), {"getSaveFileName": staticmethod(lambda *a, **k: (out, ""))})
    win.save_masks()
    assert np.load(out).shape[0] == 1
    win.close()
