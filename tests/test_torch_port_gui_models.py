"""The port's headless state models (`apps/viewer_state.py`,
`apps/labeler_state.py`) against the JAX package's, step by step as
tests/test_gui_models.py drives them: the same payloads and the same edits
go to both, and their tiles, curves, y-limits, d-grids, CSV files and mask
stacks are compared.

Tolerances: tiles, mask stacks, d-grids and y-limits are equal; the I(d)
curves (and the CSV columns built from them) within 1e-6 of their max: the
port rebins by fp32 segment sums in pixel order, the JAX package by XLA's
segment_sum, so a bin's sum of up to a few hundred fp32 values may differ
in its last bits. The full weights-to-CSV flow compares the stages within
1e-5 of their max, as tests/test_torch_port_viewer.py does."""

import os

import numpy as np
import pytest
import torch

from swinwnet_tpu.apps import labeler_state as jls
from swinwnet_tpu.apps import viewer_state as jvs
from swinwnet_tpu_torch.apps import labeler_state as pls
from swinwnet_tpu_torch.apps import viewer_state as pvs
from swinwnet_tpu_torch.data import synthesize_pattern
from swinwnet_tpu_torch.models import SwinWNet

CURVE_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: on some CPUs this suite has run on, now and then
    a process that ran the full flow with two threads had the second
    thread's half of `torch.sqrt` (the input's error channel) good to only
    ~12 bits, which puts the stages ~1e-4 off; on one thread it never did."""
    torch.set_num_threads(1)


def close(got, want, tol=CURVE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max(initial=0.0) <= tol * max(np.abs(want).max(initial=0.0), 1e-12)


# ---------------------------------------------------------------------------
# Viewer model
# ---------------------------------------------------------------------------


def stage_payload(tmp_path, B=3):
    rng = np.random.default_rng(0)
    payload = {
        "images": rng.uniform(0, 100, (B, 1, 50, 60)).astype(np.float32),
        "seg_map_lr": rng.uniform(0, 1, (B, 1, 50, 60)).astype(np.float32),
        "upscaled_denorm": rng.uniform(0, 100, (B, 2, 100, 120)).astype(np.float32),
        "zzz_custom": rng.uniform(0, 1, (50, 60)).astype(np.float32),
        "not_an_array": None,
    }
    p = os.path.join(tmp_path, "stages.npy")
    np.save(p, payload, allow_pickle=True)
    return p


def viewers(tmp_path):
    """(JAX ViewerModel, port ViewerModel on the CPU), both loaded from the
    same stage payload."""
    p = stage_payload(tmp_path)
    jm, pm = jvs.ViewerModel(), pvs.ViewerModel(device="cpu")
    assert jm.load_npy(p) and pm.load_npy(p)
    return jm, pm


def same_tiles(jm, pm):
    jt, pt = jm.tiles(), pm.tiles()
    assert len(jt) == len(pt) > 0
    for a, b in zip(jt, pt):
        assert (a.title, a.left_title, a.right_title, a.is_mask, a.log2d) == (
            b.title, b.left_title, b.right_title, b.is_mask, b.log2d)
        np.testing.assert_array_equal(a.left, b.left)
        assert (a.right is None) == (b.right is None)
        if a.right is not None:
            np.testing.assert_array_equal(a.right, b.right)
    return pt


def same_curves(jm, pm):
    jc, pc = jm.curves(), pm.curves()
    assert len(jc) == len(pc) > 0
    for a, b in zip(jc, pc):
        assert (a.stage, a.line_visible, a.band_visible) == (b.stage, b.line_visible, b.band_visible)
        np.testing.assert_array_equal(a.d, b.d)
        close(b.I, a.I)
        assert (a.err is None) == (b.err is None)
        if a.err is not None:
            close(b.err, a.err)
    return pc


class TestViewerModel:
    def test_stage_ordering_and_helpers(self):
        names = ["zzz_custom", "seg_map_hr", "images", "alpha"]
        assert pvs.sorted_stage_names(names) == jvs.sorted_stage_names(names) == [
            "images", "seg_map_hr", "alpha", "zzz_custom"]
        for s in ("seg_map_lr", "seg_map_extra", "images_masked_hr", "SEG_MAP_HR"):
            assert pvs.is_seg_mask_stage(s) == jvs.is_seg_mask_stage(s)
        for shape in ((5, 6), (2, 5, 6), (2, 3, 5, 6)):
            assert pvs.as_4d(np.zeros(shape)).shape == jvs.as_4d(np.zeros(shape)).shape
        with pytest.raises(ValueError):
            pvs.as_4d(np.zeros(5))

    def test_load_dict_payload(self, tmp_path):
        jm, pm = viewers(tmp_path)
        assert pm.stage_order == jm.stage_order and pm.stage_order[0] == "images"
        np.testing.assert_array_equal(pm.current_images, jm.current_images)
        assert pm.batch_size() == jm.batch_size() == 3
        assert pm.stage_visible == jm.stage_visible and pm.band_visible == jm.band_visible

    def test_load_raw_array_and_empty(self, tmp_path):
        p = os.path.join(tmp_path, "raw.npy")
        np.save(p, np.ones((50, 60), np.float32))
        jm, pm = jvs.ViewerModel(), pvs.ViewerModel(device="cpu")
        assert jm.load_npy(p) and pm.load_npy(p)
        assert pm.current_images.shape == jm.current_images.shape == (1, 1, 50, 60)
        assert pm.stage_order == jm.stage_order == ["images"]
        empty = os.path.join(tmp_path, "empty.npy")
        np.save(empty, {"x": np.zeros(3)}, allow_pickle=True)
        assert not jm.load_npy(empty) and not pm.load_npy(empty)
        assert pm.status == jm.status

    def test_tiles_split_channels_except_masks(self, tmp_path):
        jm, pm = viewers(tmp_path)
        for m in (jm, pm):
            m.toggle_stage_selected("upscaled_denorm", True)
            m.toggle_stage_selected("seg_map_lr", True)
        by_stage = {t.title.split(" |")[0]: t for t in same_tiles(jm, pm)}
        assert by_stage["upscaled_denorm"].right_title == "Error"
        assert by_stage["seg_map_lr"].right is None and by_stage["seg_map_lr"].left_title == "Mask"
        for m in (jm, pm):
            m.tiles_per_stage, m.log_2d, m.sample_idx = 3, True, 1
        assert len(same_tiles(jm, pm)) == 4

    def test_curves_bands_and_visibility(self, tmp_path):
        jm, pm = viewers(tmp_path)
        for m in (jm, pm):
            m.toggle_stage_selected("images", True)
            m.toggle_stage_selected("upscaled_denorm", True)
        curves = {c.stage: c for c in same_curves(jm, pm)}
        assert curves["images"].err is None and (curves["upscaled_denorm"].err >= 0).all()
        assert pm.toggle_band("upscaled_denorm") is jm.toggle_band("upscaled_denorm") is True
        same_curves(jm, pm)
        assert pm.toggle_line("upscaled_denorm") is jm.toggle_line("upscaled_denorm") is False
        c = {c.stage: c for c in same_curves(jm, pm)}["upscaled_denorm"]
        assert not c.line_visible and not c.band_visible
        for m in (jm, pm):
            m.sample_idx = 2
        same_curves(jm, pm)

    def test_norm_1d_and_ylim(self, tmp_path):
        jm, pm = viewers(tmp_path)
        for m in (jm, pm):
            m.toggle_stage_selected("images", True)
            m.toggle_stage_selected("upscaled_denorm", True)
            m.norm_1d = True
        assert float(np.max(same_curves(jm, pm)[0].I)) <= 1.0 + 1e-6
        assert pm.ylim() == jm.ylim() == (0.0, 1.5)
        for m in (jm, pm):
            m.norm_1d = False
        assert pm.ylim() is None and jm.ylim() is None
        for m in (jm, pm):
            m.auto_ylim, m.ymin, m.ymax = False, 2.0, 1.0
        assert pm.ylim() == jm.ylim() and pm.ylim()[1] > pm.ylim()[0]

    def test_d_grid_and_geometry_rebuild(self, tmp_path):
        jm, pm = viewers(tmp_path)
        for m in (jm, pm):
            m.toggle_stage_selected("images", True)
            m.apply_d_grid(0.1, 7.0, 333)
        np.testing.assert_array_equal(pm.fixed_centers, jm.fixed_centers)
        assert len(same_curves(jm, pm)[0].d) == 333
        for m in (jm, pm):
            m.set_geometry((-90, 90), (0.5, 5.0))
        assert pm.qw.theta_range == jm.qw.theta_range == (-90.0, 90.0)
        assert pm.qw.L_range == jm.qw.L_range == (0.5, 5.0)
        same_curves(jm, pm)

    def test_export_csv_visible_only(self, tmp_path):
        jm, pm = viewers(tmp_path)
        for m in (jm, pm):
            m.toggle_stage_selected("images", True)
            m.toggle_stage_selected("seg_map_lr", True)
            m.toggle_stage_selected("upscaled_denorm", True)
            m.toggle_line("seg_map_lr")
        out_j, out_p = os.path.join(tmp_path, "j.csv"), os.path.join(tmp_path, "p.csv")
        assert pm.export_csv(out_p) == jm.export_csv(out_j) == 2
        lines_j, lines_p = open(out_j).read().splitlines(), open(out_p).read().splitlines()
        assert lines_p[0] == lines_j[0] == "d,I_images,I_upscaled_denorm"
        j = np.loadtxt(out_j, delimiter=",", skiprows=1)
        p = np.loadtxt(out_p, delimiter=",", skiprows=1)
        np.testing.assert_array_equal(p[:, 0], j[:, 0])
        for col in (1, 2):
            close(p[:, col], j[:, col])

    def test_export_nothing_visible_and_run_guards(self, tmp_path):
        jm, pm = viewers(tmp_path)
        for m in (jm, pm):
            m.toggle_stage_selected("images", True)
            m.toggle_line("images")
        assert pm.export_csv(os.path.join(tmp_path, "x.csv")) == jm.export_csv(os.path.join(tmp_path, "y.csv")) == 0
        assert not pm.run_inference() and not jm.run_inference()
        assert pm.status == jm.status == "Load weights first."

    def test_full_flow_weights_to_csv(self, tmp_path):
        """load weights (.pth) -> load images -> run inference -> tiles and
        CSV (swinwnet_viewer_gui.py:714-803), the port against the JAX
        model, from the port's seeded published weights."""
        model = SwinWNet(in_chans=1, error_matrix=True, embed_dim=48, depths=(2, 2, 2, 2),
                         num_heads=(3, 6, 12, 24), window_size=5, device="cpu",
                         generator=torch.Generator().manual_seed(0))
        pth = os.path.join(tmp_path, "m.pth")
        torch.save({"state_dict": {"module." + k: v for k, v in model.state_dict().items()}}, pth)
        npy = os.path.join(tmp_path, "img.npy")
        np.save(npy, synthesize_pattern([1.5, 3.0], [1.0, 0.7], H=50, W=60, seed=3))

        jm, pm = jvs.ViewerModel(), pvs.ViewerModel(device="cpu")
        for m in (jm, pm):
            m.load_weights(pth)
            assert m.error_matrix is True
            assert m.load_npy(npy) and m.run_inference()
        assert pm.stage_order == jm.stage_order and len(pm.stage_order) == 8
        assert pm.status == jm.status
        for name in pm.stage_order:
            want = np.asarray(jm.data[name])
            assert pm.data[name].shape == want.shape and pm.data[name].flags["C_CONTIGUOUS"], name
            assert np.abs(pm.data[name] - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-12), name
        for m in (jm, pm):
            m.toggle_stage_selected("images", True)
            m.toggle_stage_selected("images_masked_hr", True)
        assert len(pm.tiles()) == len(jm.tiles()) == 2
        out_j, out_p = os.path.join(tmp_path, "j.csv"), os.path.join(tmp_path, "p.csv")
        assert pm.export_csv(out_p) == jm.export_csv(out_j) == 2
        assert open(out_p).readline() == open(out_j).readline()
        j = np.loadtxt(out_j, delimiter=",", skiprows=1)
        p = np.loadtxt(out_p, delimiter=",", skiprows=1)
        for col in range(3):
            close(p[:, col], j[:, col], 1e-5)


# ---------------------------------------------------------------------------
# Labeler model
# ---------------------------------------------------------------------------


def labelers(tmp_path, N=3, H=50, W=60):
    imgs = np.stack([synthesize_pattern([1.2, 2.5], [2.0, 1.0], H=H, W=W, seed=i) for i in range(N)])
    p = os.path.join(tmp_path, "diff.npy")
    np.save(p, imgs)
    jm, pm = jls.LabelerModel(), pls.LabelerModel(device="cpu")
    jm.load_npy(p)
    pm.load_npy(p)
    return jm, pm


def same_state(jm, pm):
    assert (pm.idx, pm.mode_view, pm.intervals, pm.n_items(), pm.done(), pm.status_text()) == (
        jm.idx, jm.mode_view, jm.intervals, jm.n_items(), jm.done(), jm.status_text())
    jp, pp = jm.profile(), pm.profile()
    assert (jp is None) == (pp is None)
    if pp is not None:
        np.testing.assert_array_equal(pp[0], jp[0])
        close(pp[1], jp[1])
    jf, pf = jm.current_final_mask(), pm.current_final_mask()
    assert (jf is None) == (pf is None)
    if pf is not None:
        np.testing.assert_array_equal(pf, jf)


class TestLabelerModel:
    def test_mask_heuristics(self):
        cases = [np.zeros((4, 5), np.uint8), np.ones((4, 5), bool), np.zeros((4, 5), np.float32),
                 np.arange(20).reshape(4, 5), np.zeros(5, np.uint8), [[0, 1]]]
        for a in cases:
            assert pls.is_mask_array(a) == jls.is_mask_array(a)
        assert pls.normalize_to_stack(np.zeros((4, 5))).shape == (1, 4, 5)
        with pytest.raises(ValueError):
            pls.normalize_to_stack(np.zeros((2, 2, 4, 5)))

    def test_span_label_undo_clear(self, tmp_path):
        jm, pm = labelers(tmp_path)
        for m in (jm, pm):
            assert m.add_interval(2.6, 2.4) and m.add_interval(1.0, 1.4) and m.pop_interval()
        same_state(jm, pm)
        assert pm.intervals[0] == [(2.4, 2.6)]
        for m in (jm, pm):
            m.clear_intervals_current()
            assert not m.pop_interval()
        same_state(jm, pm)

    def test_profile_and_mask_projection(self, tmp_path):
        jm, pm = labelers(tmp_path)
        d, I = pm.profile()
        assert d.shape == I.shape and I.sum() > 0
        for m in (jm, pm):
            m.add_interval(2.45, 2.55)
        same_state(jm, pm)
        np.testing.assert_array_equal(pm.d_map(), jm.d_map())
        assert pm.current_final_mask().any()

    def test_navigation_and_done_state(self, tmp_path):
        jm, pm = labelers(tmp_path, N=2)
        same_state(jm, pm)
        for step in ("next_item", "next_item", "next_item", "prev_item"):
            for m in (jm, pm):
                getattr(m, step)()
            same_state(jm, pm)
        assert pm.idx == 1 and not pm.done()

    def test_mode_toggle_guard(self, tmp_path):
        assert pls.LabelerModel(device="cpu").toggle_mode() is jls.LabelerModel().toggle_mode() is False
        jm, pm = labelers(tmp_path)
        assert pm.toggle_mode() is jm.toggle_mode() is True
        assert not pm.add_interval(1, 2) and not jm.add_interval(1, 2)
        same_state(jm, pm)
        assert pm.toggle_mode() is jm.toggle_mode() is False

    def test_d_grid_and_geometry_rebuild(self, tmp_path):
        jm, pm = labelers(tmp_path)
        for m in (jm, pm):
            m.add_interval(2.45, 2.55)
            m.apply_d_grid(0.2, 6.0, 400)
        same_state(jm, pm)
        assert len(pm.profile()[0]) == 400
        for m in (jm, pm):
            m.set_geometry((-120, 120), (0.5, 8.0))
        same_state(jm, pm)

    def test_mask_stack_save_and_reload(self, tmp_path):
        jm, pm = labelers(tmp_path, N=3)
        for m in (jm, pm):
            m.add_interval(2.45, 2.55)
            m.next_item()
            m.next_item()
            m.add_interval(1.15, 1.25)
        np.testing.assert_array_equal(pm.masks_stack(), jm.masks_stack())
        out_j, out_p = os.path.join(tmp_path, "j", "masks.npy"), os.path.join(tmp_path, "p", "masks.npy")
        os.makedirs(os.path.dirname(out_j))
        os.makedirs(os.path.dirname(out_p))
        assert pm.save_masks(out_p) == jm.save_masks(out_j) == 2
        np.testing.assert_array_equal(np.load(out_p), np.load(out_j))
        np.testing.assert_array_equal(np.load(out_p.replace(".npy", "_indices.npy")), [0, 2])
        jm2, pm2 = jls.LabelerModel(), pls.LabelerModel(device="cpu")
        jm2.load_npy(out_j)
        pm2.load_npy(out_p)
        assert pm2.diffractions is None and pm2.mode_view is jm2.mode_view is True
        np.testing.assert_array_equal(pm2.masks_stack(), jm2.masks_stack())
        assert pm2.status_text() == jm2.status_text()

    def test_save_nothing(self, tmp_path):
        jm, pm = labelers(tmp_path)
        assert pm.save_masks(os.path.join(tmp_path, "p.npy")) == jm.save_masks(os.path.join(tmp_path, "j.npy")) == 0
        assert pls.LabelerModel(device="cpu").save_masks(os.path.join(tmp_path, "n.npy")) == 0

    def test_base_masks_or_intervals(self, tmp_path):
        jm, pm = labelers(tmp_path, N=2)
        base = np.zeros((2, 50, 60), np.uint8)
        base[0, :5, :5] = 1
        bp = os.path.join(tmp_path, "base.npy")
        np.save(bp, base)
        for m in (jm, pm):
            m.load_npy(bp)
            m.mode_view = False
            m.add_interval(2.45, 2.55)
        same_state(jm, pm)
        fm = pm.current_final_mask()
        assert fm[:5, :5].all() and fm.sum() > 25
        np.testing.assert_array_equal(pm.masks_stack(), jm.masks_stack())
