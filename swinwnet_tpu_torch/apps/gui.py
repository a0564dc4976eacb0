"""Interactive GUI shells (port of `swinwnet_tpu/apps/gui.py`; reference:
inference_gui/swinwnet_viewer_gui.py and
DiffractionLabeler/diffraction_labeling_gui/diff_labeling_gui.py).

All behavior lives in the toolkit-agnostic controllers
(`apps.viewer_state.ViewerModel`, `apps.labeler_state.LabelerModel`) — this
module is only Qt wiring + matplotlib drawing, so the same features are
unit-tested headless while the shells stay thin. PySide6 + matplotlib are
optional dependencies (a serving machine has no display stack); the smoke
tests run both windows offscreen (QT_QPA_PLATFORM=offscreen) where PySide6
is installed. The viewer's model and rebinner run on the card.

Launch:
    python -m swinwnet_tpu_torch.apps.gui viewer
    python -m swinwnet_tpu_torch.apps.gui labeler
"""

from __future__ import annotations

import sys

import numpy as np


def _require_qt():
    try:
        import PySide6  # noqa: F401
        import matplotlib

        matplotlib.use("QtAgg", force=False)
    except ImportError as e:
        raise ImportError(
            "The GUI shells require PySide6 + matplotlib. All functionality "
            "is available headless: `python -m swinwnet_tpu_torch.apps.viewer` "
            "for inference + I(d) export, and "
            "`swinwnet_tpu_torch.apps.labeler_state` for interval labeling."
        ) from e


# ---------------------------------------------------------------------------
# Viewer window
# ---------------------------------------------------------------------------


def build_viewer_window():
    """Construct (window, model); separated from exec() for offscreen tests."""
    _require_qt()
    from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg as FigureCanvas
    from matplotlib.figure import Figure
    from PySide6.QtCore import Qt
    from PySide6.QtWidgets import (
        QCheckBox, QDoubleSpinBox, QFileDialog, QGridLayout, QGroupBox,
        QHBoxLayout, QLabel, QMainWindow, QMessageBox, QPushButton,
        QScrollArea, QSpinBox, QSplitter, QVBoxLayout, QWidget,
    )

    from .viewer_state import ViewerModel

    class Mpl1DCanvas(FigureCanvas):
        def __init__(self):
            fig = Figure(figsize=(7, 3), tight_layout=True)
            self.ax = fig.add_subplot(111)
            super().__init__(fig)

    class TileCanvas(FigureCanvas):
        """One stage tile: 1 or 2 imshow panels with detector extent."""

        def __init__(self, tile, theta_range, lam_range):
            ncols = 2 if tile.right is not None else 1
            fig = Figure(figsize=(4.2 * ncols, 2.6), tight_layout=True)
            super().__init__(fig)
            extent = [theta_range[0], theta_range[1], lam_range[0], lam_range[1]]
            for i, (img, title) in enumerate(
                [(tile.left, tile.left_title)]
                + ([(tile.right, tile.right_title)] if tile.right is not None else [])
            ):
                ax = fig.add_subplot(1, ncols, i + 1)
                data = np.asarray(img, np.float64)
                if tile.log2d and not tile.is_mask:
                    data = np.log1p(np.maximum(data, 0))
                ax.imshow(
                    data, origin="lower", aspect="auto", extent=extent,
                    cmap="gray" if tile.is_mask else "viridis",
                )
                ax.set_title(f"{tile.title} | {title}" if title else tile.title, fontsize=8)
                ax.set_xlabel("theta, deg", fontsize=7)
                ax.set_ylabel("lambda, A", fontsize=7)
                ax.tick_params(labelsize=6)

    class ViewerWindow(QMainWindow):
        def __init__(self, model: ViewerModel | None = None):
            super().__init__()
            self.setWindowTitle("SwinWNet Inference Viewer")
            self.setAcceptDrops(True)
            self.m = model or ViewerModel()
            self._stage_buttons = {}
            self._legend_items = {}
            self._lines = {}
            self._bands = {}
            self._legend = None

            root = QWidget()
            self.setCentralWidget(root)
            outer = QHBoxLayout(root)
            splitter = QSplitter(Qt.Horizontal)
            outer.addWidget(splitter)

            # ---- left control column ----
            left = QWidget()
            left.setMinimumWidth(360)
            ll = QVBoxLayout(left)

            io_box = QGroupBox("I/O")
            ig = QGridLayout(io_box)
            self.btn_open = QPushButton("Open .npy (dict or array)")
            self.btn_open.clicked.connect(self.open_file)
            self.btn_export = QPushButton("Export visible curves to CSV")
            self.btn_export.clicked.connect(self.export_csv)
            ig.addWidget(self.btn_open, 0, 0)
            ig.addWidget(self.btn_export, 1, 0)
            ll.addWidget(io_box)

            m_box = QGroupBox("Model")
            mg = QGridLayout(m_box)
            self.btn_weights = QPushButton("Load weights (.pth/.pt)")
            self.btn_weights.clicked.connect(self.action_load_weights)
            self.btn_run = QPushButton("Run inference on loaded images")
            self.btn_run.clicked.connect(self.run_inference_and_refresh)
            mg.addWidget(self.btn_weights, 0, 0)
            mg.addWidget(self.btn_run, 1, 0)
            ll.addWidget(m_box)

            v_box = QGroupBox("View")
            vg = QGridLayout(v_box)
            self.spin_sample = QSpinBox()
            self.spin_sample.setRange(0, 0)
            self.spin_sample.valueChanged.connect(self._on_view_changed)
            self.spin_tiles = QSpinBox()
            self.spin_tiles.setRange(1, 64)
            self.spin_tiles.setValue(1)
            self.spin_tiles.valueChanged.connect(self._on_view_changed)
            self.chk_norm1d = QCheckBox("Normalize 1D (each curve / max)")
            self.chk_norm1d.stateChanged.connect(self._on_view_changed)
            self.chk_log2d = QCheckBox("Log scale for 2D")
            self.chk_log2d.stateChanged.connect(self._on_view_changed)
            self.chk_auto_y = QCheckBox("Auto Y")
            self.chk_auto_y.setChecked(True)
            self.chk_auto_y.stateChanged.connect(self._on_view_changed)
            self.spin_ymin = QDoubleSpinBox()
            self.spin_ymin.setRange(-1e12, 1e12)
            self.spin_ymin.setDecimals(6)
            self.spin_ymin.setValue(-1.0)
            self.spin_ymin.valueChanged.connect(self._on_view_changed)
            self.spin_ymax = QDoubleSpinBox()
            self.spin_ymax.setRange(-1e12, 1e12)
            self.spin_ymax.setDecimals(6)
            self.spin_ymax.setValue(1.0)
            self.spin_ymax.valueChanged.connect(self._on_view_changed)
            vg.addWidget(QLabel("Sample index (B)"), 0, 0)
            vg.addWidget(self.spin_sample, 0, 1)
            vg.addWidget(QLabel("Tiles per stage"), 1, 0)
            vg.addWidget(self.spin_tiles, 1, 1)
            vg.addWidget(self.chk_norm1d, 2, 0, 1, 2)
            vg.addWidget(self.chk_log2d, 3, 0, 1, 2)
            vg.addWidget(self.chk_auto_y, 4, 0, 1, 2)
            vg.addWidget(QLabel("y_min"), 5, 0)
            vg.addWidget(self.spin_ymin, 5, 1)
            vg.addWidget(QLabel("y_max"), 6, 0)
            vg.addWidget(self.spin_ymax, 6, 1)
            ll.addWidget(v_box)

            d_box = QGroupBox("d-grid")
            dg = QGridLayout(d_box)
            self.spin_dmin = QDoubleSpinBox()
            self.spin_dmin.setDecimals(6)
            self.spin_dmin.setRange(1e-6, 1e6)
            self.spin_dmin.setValue(float(self.m.fixed_centers[0]))
            self.spin_dmax = QDoubleSpinBox()
            self.spin_dmax.setDecimals(6)
            self.spin_dmax.setRange(1e-6, 1e6)
            self.spin_dmax.setValue(float(self.m.fixed_centers[-1]))
            self.spin_dn = QSpinBox()
            self.spin_dn.setRange(16, 200000)
            self.spin_dn.setValue(int(self.m.fixed_centers.size))
            btn_dgrid = QPushButton("Apply d-grid")
            btn_dgrid.clicked.connect(self.apply_d_grid)
            dg.addWidget(QLabel("d_min"), 0, 0)
            dg.addWidget(self.spin_dmin, 0, 1)
            dg.addWidget(QLabel("d_max"), 1, 0)
            dg.addWidget(self.spin_dmax, 1, 1)
            dg.addWidget(QLabel("N"), 2, 0)
            dg.addWidget(self.spin_dn, 2, 1)
            dg.addWidget(btn_dgrid, 3, 0, 1, 2)
            ll.addWidget(d_box)

            g_box = QGroupBox("2D geometry (theta / lambda)")
            gg = QGridLayout(g_box)
            self.spin_tmin = QDoubleSpinBox()
            self.spin_tmin.setDecimals(3)
            self.spin_tmin.setRange(-360, 360)
            self.spin_tmin.setValue(self.m.theta_range[0])
            self.spin_tmax = QDoubleSpinBox()
            self.spin_tmax.setDecimals(3)
            self.spin_tmax.setRange(-360, 360)
            self.spin_tmax.setValue(self.m.theta_range[1])
            self.spin_lmin = QDoubleSpinBox()
            self.spin_lmin.setDecimals(6)
            self.spin_lmin.setRange(1e-9, 1e6)
            self.spin_lmin.setValue(self.m.lambda_range[0])
            self.spin_lmax = QDoubleSpinBox()
            self.spin_lmax.setDecimals(6)
            self.spin_lmax.setRange(1e-9, 1e6)
            self.spin_lmax.setValue(self.m.lambda_range[1])
            for s in (self.spin_tmin, self.spin_tmax, self.spin_lmin, self.spin_lmax):
                s.valueChanged.connect(self._on_geometry_changed)
            gg.addWidget(QLabel("theta_min"), 0, 0)
            gg.addWidget(self.spin_tmin, 0, 1)
            gg.addWidget(QLabel("theta_max"), 0, 2)
            gg.addWidget(self.spin_tmax, 0, 3)
            gg.addWidget(QLabel("lambda_min"), 1, 0)
            gg.addWidget(self.spin_lmin, 1, 1)
            gg.addWidget(QLabel("lambda_max"), 1, 2)
            gg.addWidget(self.spin_lmax, 1, 3)
            ll.addWidget(g_box)

            ll.addStretch(1)
            self.lbl_status = QLabel(self.m.status)
            self.lbl_status.setWordWrap(True)
            ll.addWidget(self.lbl_status)

            # ---- right: stage buttons / tiles / plot ----
            right = QWidget()
            rl = QVBoxLayout(right)
            self.stage_row = QHBoxLayout()
            self.stage_row.setSpacing(6)
            rl.addLayout(self.stage_row)

            self.tiles_scroll = QScrollArea()
            self.tiles_scroll.setWidgetResizable(True)
            tiles_root = QWidget()
            self.tiles_grid = QGridLayout(tiles_root)
            self.tiles_grid.setSpacing(8)
            self.tiles_scroll.setWidget(tiles_root)
            rl.addWidget(self.tiles_scroll, 3)

            self.plot = Mpl1DCanvas()
            rl.addWidget(self.plot, 2)
            self.plot.ax.set_title("I(d) | click legend items to hide/show")
            self.plot.ax.set_xlabel("d, Å")
            self.plot.ax.set_ylabel("Intensity / Mask sum")
            self.plot.mpl_connect("pick_event", self._on_pick_legend)

            splitter.addWidget(left)
            splitter.addWidget(right)
            splitter.setStretchFactor(0, 0)
            splitter.setStretchFactor(1, 1)
            self._msg = QMessageBox  # patchable in tests
            self._file_dialog = QFileDialog

        # ---------- drag & drop ----------

        def dragEnterEvent(self, event):
            if event.mimeData().hasUrls():
                event.acceptProposedAction()

        def dropEvent(self, event):
            for url in event.mimeData().urls():
                p = url.toLocalFile()
                if p.endswith(".npy"):
                    self.load_npy(p)
                elif p.endswith((".pth", ".pt")):
                    self.load_weights(p)

        # ---------- actions ----------

        def open_file(self):
            path, _ = self._file_dialog.getOpenFileName(
                self, "Open .npy", "", "NumPy files (*.npy)"
            )
            if path:
                self.load_npy(path)

        def load_npy(self, path: str):
            try:
                ok = self.m.load_npy(path)
            except Exception as e:  # pragma: no cover - dialog path
                self._msg.critical(self, "Load error", f"Failed to load:\n{path}\n\n{e}")
                return
            self._sync_after_data(ok)

        def action_load_weights(self):
            path, _ = self._file_dialog.getOpenFileName(
                self, "Load weights", "", "Torch checkpoints (*.pth *.pt)"
            )
            if path:
                self.load_weights(path)

        def load_weights(self, path: str):
            try:
                self.m.load_weights(path)
            except Exception as e:  # pragma: no cover - dialog path
                self._msg.critical(self, "Weights error", f"{e}")
                return
            self.lbl_status.setText(self.m.status)

        def run_inference_and_refresh(self):
            try:
                ok = self.m.run_inference()
            except Exception as e:  # pragma: no cover - dialog path
                self._msg.critical(self, "Inference error", f"{e}")
                return
            self._sync_after_data(ok)

        def export_csv(self):
            path, _ = self._file_dialog.getSaveFileName(
                self, "Save CSV", "diffraction_curves.csv", "CSV files (*.csv)"
            )
            if not path:
                return
            n = self.m.export_csv(path)
            if n == 0:
                self._msg.information(self, "Nothing to export", "All curves are hidden.")
            else:
                self.lbl_status.setText(f"CSV saved ({n} curves): {path}")

        def apply_d_grid(self):
            self.m.apply_d_grid(
                self.spin_dmin.value(), self.spin_dmax.value(), self.spin_dn.value()
            )
            self.refresh_all()

        # ---------- sync / render ----------

        def _on_geometry_changed(self, *_):
            self.m.set_geometry(
                (self.spin_tmin.value(), self.spin_tmax.value()),
                (self.spin_lmin.value(), self.spin_lmax.value()),
            )
            self.refresh_all()

        def _on_view_changed(self, *_):
            self.m.sample_idx = self.spin_sample.value()
            self.m.tiles_per_stage = self.spin_tiles.value()
            self.m.norm_1d = self.chk_norm1d.isChecked()
            self.m.log_2d = self.chk_log2d.isChecked()
            self.m.auto_ylim = self.chk_auto_y.isChecked()
            self.m.ymin = self.spin_ymin.value()
            self.m.ymax = self.spin_ymax.value()
            self.refresh_all()

        def _sync_after_data(self, ok: bool):
            self.lbl_status.setText(self.m.status)
            if not ok:
                return
            self.spin_sample.setRange(0, max(0, self.m.batch_size() - 1))
            self.spin_sample.setValue(0)
            self._rebuild_stage_buttons()
            self.refresh_all()

        def _rebuild_stage_buttons(self):
            while self.stage_row.count():
                item = self.stage_row.takeAt(0)
                w = item.widget()
                if w is not None:
                    w.setParent(None)
                    w.deleteLater()
            from PySide6.QtWidgets import QToolButton

            self._stage_buttons = {}
            for st in self.m.stage_order:
                b = QToolButton()
                b.setText(st)
                b.setCheckable(True)
                b.setChecked(st in self.m.selected_stages)
                b.toggled.connect(lambda on, s=st: self.toggle_stage(s, on))
                self.stage_row.addWidget(b)
                self._stage_buttons[st] = b
            self.stage_row.addStretch(1)

        def toggle_stage(self, stage: str, checked: bool):
            self.m.toggle_stage_selected(stage, checked)
            self.refresh_all()

        def refresh_all(self):
            self._render_tiles()
            self._render_plot()

        def _render_tiles(self):
            while self.tiles_grid.count():
                item = self.tiles_grid.takeAt(0)
                w = item.widget()
                if w is not None:
                    w.setParent(None)
                    w.deleteLater()
            row = col = 0
            for tile in self.m.tiles():
                w = TileCanvas(tile, self.m.theta_range, self.m.lambda_range)
                self.tiles_grid.addWidget(w, row, col)
                col += 1
                if col >= 2:
                    col = 0
                    row += 1
            self.tiles_grid.setRowStretch(row + 1, 1)

        def _render_plot(self):
            ax = self.plot.ax
            ax.clear()
            ax.set_title("I(d) | click legend items to hide/show")
            ax.set_xlabel("d, Å")
            ax.set_ylabel("Intensity / Mask sum")
            self._lines = {}
            self._bands = {}
            self._legend = None
            self._legend_items = {}

            curves = self.m.curves()
            if not curves:
                self.plot.draw()
                return

            for c in curves:
                (line,) = ax.plot(c.d, c.I, label=c.stage)
                line.set_visible(c.line_visible)
                self._lines[c.stage] = line
                if c.err is not None:
                    band = ax.fill_between(
                        c.d, c.I - c.err, c.I + c.err,
                        color=line.get_color(), alpha=0.2, linewidth=0.0,
                        label=f"{c.stage} error",
                    )
                    band.set_visible(c.band_visible)
                    self._bands[c.stage] = band

            leg = ax.legend(loc="best", frameon=True)
            self._legend = leg
            for h, t in zip(leg.legend_handles, leg.get_texts()):
                label = t.get_text()
                t.set_picker(True)
                h.set_picker(True)
                if label.endswith(" error"):
                    stage, kind = label[:-6], "band"
                    on = self.m.band_visible.get(stage, False)
                else:
                    stage, kind = label, "line"
                    on = self.m.stage_visible.get(stage, True)
                h._stage = t._stage = stage
                h._kind = t._kind = kind
                self._legend_items[label] = (h, t)
                h.set_alpha(1.0 if on else 0.3)
                t.set_alpha(1.0 if on else 0.3)

            lim = self.m.ylim()
            if lim is None:
                ax.autoscale(enable=True, axis="y")
            else:
                ax.set_ylim(*lim)
            self.plot.draw()

        def _on_pick_legend(self, event):
            stage = getattr(event.artist, "_stage", None)
            kind = getattr(event.artist, "_kind", None)
            if stage is None or kind is None:
                return
            if kind == "line":
                vis = self.m.toggle_line(stage)
                if stage in self._lines:
                    self._lines[stage].set_visible(vis)
                if stage in self._bands:
                    self._bands[stage].set_visible(
                        self.m.band_visible.get(stage, False) and vis
                    )
            else:
                vis = self.m.toggle_band(stage)
                if stage in self._bands:
                    self._bands[stage].set_visible(
                        vis and self.m.stage_visible.get(stage, True)
                    )
            for label, (h, t) in self._legend_items.items():
                if label.endswith(" error"):
                    on = self.m.band_visible.get(label[:-6], False)
                else:
                    on = self.m.stage_visible.get(label, True)
                h.set_alpha(1.0 if on else 0.3)
                t.set_alpha(1.0 if on else 0.3)
            self.plot.draw_idle()

    from .viewer_state import ViewerModel as _VM

    model = _VM()
    return ViewerWindow(model), model


# ---------------------------------------------------------------------------
# Labeler window
# ---------------------------------------------------------------------------


def build_labeler_window():
    """Construct (window, model); separated from exec() for offscreen tests."""
    _require_qt()
    from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg as FigureCanvas
    from matplotlib.figure import Figure
    from matplotlib.widgets import SpanSelector
    from PySide6.QtWidgets import (
        QCheckBox, QDoubleSpinBox, QFileDialog, QGridLayout, QGroupBox,
        QHBoxLayout, QLabel, QMainWindow, QMessageBox, QPushButton, QSpinBox,
        QVBoxLayout, QWidget,
    )

    from .labeler_state import LabelerModel

    class LabelerCanvas(FigureCanvas):
        def __init__(self):
            fig = Figure(figsize=(9, 7), tight_layout=True)
            self.ax_2d = fig.add_subplot(221)
            self.ax_mask = fig.add_subplot(222)
            self.ax_prof = fig.add_subplot(212)
            super().__init__(fig)

    class LabelerWindow(QMainWindow):
        def __init__(self, model: LabelerModel | None = None):
            super().__init__()
            self.setWindowTitle("SwinWNet Diffraction Labeler")
            self.setAcceptDrops(True)
            self.m = model or LabelerModel()
            self.log_y = False

            root = QWidget()
            self.setCentralWidget(root)
            outer = QHBoxLayout(root)

            left = QWidget()
            left.setMinimumWidth(300)
            ll = QVBoxLayout(left)

            io_box = QGroupBox("I/O")
            ig = QGridLayout(io_box)
            self.btn_open = QPushButton("Open .npy")
            self.btn_open.clicked.connect(self.open_npy)
            self.btn_save = QPushButton("Save masks .npy")
            self.btn_save.clicked.connect(self.save_masks)
            ig.addWidget(self.btn_open, 0, 0)
            ig.addWidget(self.btn_save, 1, 0)
            ll.addWidget(io_box)

            nav_box = QGroupBox("Navigation / labeling")
            ng = QGridLayout(nav_box)
            self.btn_prev = QPushButton("Prev")
            self.btn_prev.clicked.connect(self.prev_item)
            self.btn_next = QPushButton("Next")
            self.btn_next.clicked.connect(self.next_item)
            self.btn_mode = QPushButton("View masks")
            self.btn_mode.clicked.connect(self.toggle_mode)
            self.btn_clear = QPushButton("Clear intervals (current)")
            self.btn_clear.clicked.connect(self.clear_intervals)
            ng.addWidget(self.btn_prev, 0, 0)
            ng.addWidget(self.btn_next, 0, 1)
            ng.addWidget(self.btn_mode, 1, 0, 1, 2)
            ng.addWidget(self.btn_clear, 2, 0, 1, 2)
            ll.addWidget(nav_box)

            d_box = QGroupBox("d-grid")
            dg = QGridLayout(d_box)
            self.spin_dmin = QDoubleSpinBox()
            self.spin_dmin.setDecimals(6)
            self.spin_dmin.setRange(1e-6, 1e6)
            self.spin_dmin.setValue(float(self.m.fixed_centers[0]))
            self.spin_dmax = QDoubleSpinBox()
            self.spin_dmax.setDecimals(6)
            self.spin_dmax.setRange(1e-6, 1e6)
            self.spin_dmax.setValue(float(self.m.fixed_centers[-1]))
            self.spin_dn = QSpinBox()
            self.spin_dn.setRange(16, 200000)
            self.spin_dn.setValue(int(self.m.fixed_centers.size))
            btn_apply = QPushButton("Apply d-grid")
            btn_apply.clicked.connect(self.apply_d_grid)
            dg.addWidget(QLabel("d_min"), 0, 0)
            dg.addWidget(self.spin_dmin, 0, 1)
            dg.addWidget(QLabel("d_max"), 1, 0)
            dg.addWidget(self.spin_dmax, 1, 1)
            dg.addWidget(QLabel("N"), 2, 0)
            dg.addWidget(self.spin_dn, 2, 1)
            dg.addWidget(btn_apply, 3, 0, 1, 2)
            ll.addWidget(d_box)

            g_box = QGroupBox("Geometry (theta / lambda)")
            gg = QGridLayout(g_box)
            self.spin_tmin = QDoubleSpinBox()
            self.spin_tmin.setRange(-360, 360)
            self.spin_tmin.setValue(self.m.theta_range[0])
            self.spin_tmax = QDoubleSpinBox()
            self.spin_tmax.setRange(-360, 360)
            self.spin_tmax.setValue(self.m.theta_range[1])
            self.spin_lmin = QDoubleSpinBox()
            self.spin_lmin.setDecimals(6)
            self.spin_lmin.setRange(1e-9, 1e6)
            self.spin_lmin.setValue(self.m.lambda_range[0])
            self.spin_lmax = QDoubleSpinBox()
            self.spin_lmax.setDecimals(6)
            self.spin_lmax.setRange(1e-9, 1e6)
            self.spin_lmax.setValue(self.m.lambda_range[1])
            for s in (self.spin_tmin, self.spin_tmax, self.spin_lmin, self.spin_lmax):
                s.valueChanged.connect(self._on_geometry_changed)
            gg.addWidget(QLabel("theta_min"), 0, 0)
            gg.addWidget(self.spin_tmin, 0, 1)
            gg.addWidget(QLabel("theta_max"), 0, 2)
            gg.addWidget(self.spin_tmax, 0, 3)
            gg.addWidget(QLabel("lambda_min"), 1, 0)
            gg.addWidget(self.spin_lmin, 1, 1)
            gg.addWidget(QLabel("lambda_max"), 1, 2)
            gg.addWidget(self.spin_lmax, 1, 3)
            ll.addWidget(g_box)

            self.chk_logy = QCheckBox("Log Y (profile)")
            self.chk_logy.stateChanged.connect(self._on_logy)
            ll.addWidget(self.chk_logy)

            ll.addStretch(1)
            self.lbl_status = QLabel(self.m.status_text())
            self.lbl_status.setWordWrap(True)
            ll.addWidget(self.lbl_status)

            self.canvas = LabelerCanvas()
            outer.addWidget(left)
            outer.addWidget(self.canvas, 1)

            # SpanSelector on the profile axis: drag an interval to label it
            # (diff_labeling_gui.py:296-311); right-click = undo last.
            self._span = SpanSelector(
                self.canvas.ax_prof,
                self._on_span,
                "horizontal",
                useblit=True,
                props=dict(alpha=0.25, facecolor="red"),
            )
            self.canvas.mpl_connect("button_press_event", self._on_click)
            self._msg = QMessageBox
            self._file_dialog = QFileDialog

        # ---------- events ----------

        def _on_span(self, xmin, xmax):
            if self.m.add_interval(xmin, xmax):
                self.refresh()

        def _on_click(self, event):
            if event.inaxes is self.canvas.ax_prof and event.button == 3:
                if self.m.pop_interval():
                    self.refresh()

        def _on_geometry_changed(self, *_):
            self.m.set_geometry(
                (self.spin_tmin.value(), self.spin_tmax.value()),
                (self.spin_lmin.value(), self.spin_lmax.value()),
            )
            self.refresh()

        def _on_logy(self, *_):
            self.log_y = self.chk_logy.isChecked()
            self.refresh()

        def dragEnterEvent(self, event):
            if event.mimeData().hasUrls():
                event.acceptProposedAction()

        def dropEvent(self, event):
            for url in event.mimeData().urls():
                p = url.toLocalFile()
                if p.endswith(".npy"):
                    self.load_npy(p)

        # ---------- actions ----------

        def open_npy(self):
            path, _ = self._file_dialog.getOpenFileName(
                self, "Open .npy", "", "NumPy files (*.npy)"
            )
            if path:
                self.load_npy(path)

        def load_npy(self, path: str):
            try:
                self.m.load_npy(path)
            except Exception as e:  # pragma: no cover - dialog path
                self._msg.critical(self, "Load error", f"Failed to load npy:\n{path}\n\n{e}")
                return
            self.refresh()

        def save_masks(self):
            path, _ = self._file_dialog.getSaveFileName(
                self, "Save labeled masks .npy", "masks_labeled.npy", "NumPy files (*.npy)"
            )
            if not path:
                return
            n = self.m.save_masks(path)
            if n == 0:
                self._msg.information(self, "Nothing to save", "All masks are empty.")
            else:
                self.lbl_status.setText(f"Saved {n} masks to {path}")

        def prev_item(self):
            self.m.prev_item()
            self.refresh()

        def next_item(self):
            self.m.next_item()
            self.refresh()

        def toggle_mode(self):
            view = self.m.toggle_mode()
            self.btn_mode.setText("Back to labeling" if view else "View masks")
            self.refresh()

        def clear_intervals(self):
            self.m.clear_intervals_current()
            self.refresh()

        def apply_d_grid(self):
            self.m.apply_d_grid(
                self.spin_dmin.value(), self.spin_dmax.value(), self.spin_dn.value()
            )
            self.refresh()

        # ---------- rendering ----------

        def refresh(self):
            ax2, axm, axp = self.canvas.ax_2d, self.canvas.ax_mask, self.canvas.ax_prof
            for ax in (ax2, axm, axp):
                ax.clear()
            m = self.m

            if m.mode_view and m.base_masks is not None and not m.done():
                axm.imshow(m.base_masks[m.idx], origin="lower", aspect="auto", cmap="gray")
                axm.set_title(f"mask {m.idx}")
            elif m.diffractions is not None and not m.done():
                img = m.diffractions[m.idx]
                ax2.imshow(np.log1p(np.maximum(img, 0)), origin="lower", aspect="auto",
                           cmap="viridis")
                ax2.set_title(f"diffraction {m.idx} (log)")
                fm = m.current_final_mask()
                if fm is not None:
                    axm.imshow(fm, origin="lower", aspect="auto", cmap="gray")
                    axm.set_title("current mask")
                prof = m.profile()
                if prof is not None:
                    d, I = prof
                    axp.plot(d, I, lw=0.8)
                    for a, b in m.intervals[m.idx]:
                        axp.axvspan(a, b, alpha=0.25, color="red")
                    if self.log_y:
                        axp.set_yscale("log")
                    axp.set_xlabel("d, Å")
                    axp.set_ylabel("I")
                    axp.set_title("drag to label | right-click to undo")
            self.lbl_status.setText(m.status_text())
            self.canvas.draw_idle()

    from .labeler_state import LabelerModel as _LM

    model = _LM()
    return LabelerWindow(model), model


# ---------------------------------------------------------------------------
# Entrypoints
# ---------------------------------------------------------------------------


def run_viewer():
    _require_qt()
    from PySide6.QtWidgets import QApplication

    app = QApplication.instance() or QApplication(sys.argv)
    win, _ = build_viewer_window()
    win.resize(1600, 900)
    win.show()
    sys.exit(app.exec())


def run_labeler():
    _require_qt()
    from PySide6.QtWidgets import QApplication

    app = QApplication.instance() or QApplication(sys.argv)
    win, _ = build_labeler_window()
    win.resize(1400, 900)
    win.show()
    sys.exit(app.exec())


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    which = argv[0] if argv else "viewer"
    if which == "viewer":
        run_viewer()
    elif which == "labeler":
        run_labeler()
    else:
        raise SystemExit(f"unknown app {which!r}; choose 'viewer' or 'labeler'")


if __name__ == "__main__":
    main()
