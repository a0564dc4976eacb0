"""Peak detection on 1D I(d) spectra on the device (port of
`swinwnet_tpu/physics/peaks.py`).

`find_peaks_device` is scipy's `find_peaks` (local maxima with the plateau
rule, then the height, distance, prominence and width gates, in scipy's
order) over a batch of spectra `[B, n]` at once, returning a fixed-size
padded peak table per spectrum. The JAX package writes it for one spectrum
and vmaps it; here every step is batched from the start, and the one
sequential step, the distance gate, loops over a static count of ranks for
the whole batch together. The gate is the device span
`physics.distance_gate` (a `device.physics.distance_gate` record a replay
of a captured program, such as the RL step) and is counted by
`distance_gate`.

The host-side spec transcription (`find_peaks_for_batch` etc., used where
exact scipy parity matters) is :mod:`.host_oracle`'s, re-exported here.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..utils.profiling import Counter, device_span
from .host_oracle import extract_peak_region, find_peaks_for_batch  # noqa: F401
from .qwrapper import as_device_tensor

MAX_PEAKS = 64  # static peak-table capacity
DISTANCE_GATES = Counter("distance_gate")  # passes of the distance gate, one a batch of spectra


def _local_maxima_mask(I: torch.Tensor) -> torch.Tensor:
    """scipy `_local_maxima_1d` over [B, n]: a candidate starts where
    I[i-1] < I[i]; its plateau ends at the first j > i with I[j] != I[i]; it
    is a maximum iff I[j] < I[i], reported at (i + j - 1) // 2 (the
    left-most middle sample). The two edges are never peaks."""
    B, n = I.shape
    idx = torch.arange(n, device=I.device)
    rises = torch.zeros_like(I, dtype=torch.bool)
    rises[:, 1:] = I[:, 1:] > I[:, :-1]
    diff_right = torch.ones_like(I, dtype=torch.bool)
    diff_right[:, :-1] = I[:, 1:] != I[:, :-1]
    # j(i): the first position after i's plateau, a reverse running minimum
    # of "the position after i where the value changes" (n inside a plateau)
    change_pos = torch.where(diff_right, idx + 1, n)
    j = torch.cummin(change_pos.flip(-1), dim=-1).values.flip(-1)
    falls = (j < n) & (I.gather(1, j.clamp(max=n - 1)) < I)
    mid = (idx + j - 1) // 2
    # write into an n + 1 buffer: non-candidates land in the last slot
    mask = torch.zeros(B, n + 1, dtype=torch.bool, device=I.device)
    mask.scatter_(1, torch.where(rises & falls, mid, n), True)
    mask = mask[:, :n]
    mask[:, 0] = False
    mask[:, -1] = False
    return mask


def _prominences(I: torch.Tensor, peak_mask: torch.Tensor) -> torch.Tensor:
    """scipy `peak_prominences` with the full window over [B, n]: left base
    = min of I over (last j < i with I[j] > I[i], i], the right base the
    same mirrored; prominence = I - max(bases), 0 off the peaks. Quadratic
    in n ([B, n, n] intermediates)."""
    n = I.shape[1]
    idx = torch.arange(n, device=I.device, dtype=torch.int32)

    def one_side(I_):
        gt = I_[:, None, :] > I_[:, :, None]  # gt[b, i, j] = I[j] > I[i]
        left_of = idx[None, :] < idx[:, None]
        barrier = torch.where(gt & left_of, idx, -1).amax(-1)  # last j < i with I[j] > I[i]
        in_win = (idx > barrier[..., None]) & (idx <= idx[:, None])
        return torch.where(in_win, I_[:, None, :], torch.inf).amin(-1)

    left_min = one_side(I)
    right_min = one_side(I.flip(-1)).flip(-1)
    prom = I - torch.maximum(left_min, right_min)
    return torch.where(peak_mask, prom, 0.0)


def _widths(I: torch.Tensor, peak_mask: torch.Tensor, prom: torch.Tensor, rel_height: float = 0.5) -> torch.Tensor:
    """scipy `peak_widths` at rel_height of the prominence over [B, n]: the
    nearest samples below the evaluation height on each side, interpolated."""
    n = I.shape[1]
    idx = torch.arange(n, device=I.device, dtype=torch.int32)
    height_eval = I - prom * rel_height
    below = I[:, None, :] < height_eval[:, :, None]
    left_cand = torch.where(below & (idx[None, :] < idx[:, None]), idx, -1).amax(-1).long()
    right_cand = torch.where(below & (idx[None, :] > idx[:, None]), idx, n).amin(-1).long()

    def at(j):
        return I.gather(1, j.clamp(0, n - 1))

    # left crossing between j and j + 1, right crossing between j - 1 and j
    j = left_cand.clamp(0, n - 1)
    frac = torch.where(left_cand >= 0, (height_eval - at(j)) / (at(j + 1) - at(j) + 1e-30), 0.0)
    lips = torch.where(left_cand >= 0, j + frac, 0.0)
    j = right_cand.clamp(0, n - 1)
    frac = torch.where(right_cand < n, (height_eval - at(j)) / (at(j - 1) - at(j) + 1e-30), 0.0)
    rips = torch.where(right_cand < n, j - frac, float(n - 1))
    return torch.where(peak_mask, rips - lips, 0.0)


def max_candidates(n: int) -> int:
    """The most local maxima a length-n spectrum can hold, (n - 1) // 2: the
    edges are never peaks, and two maxima need a lower sample between them
    (an alternating spectrum reaches it)."""
    return (n - 1) // 2


def _enforce_distance(peak_mask: torch.Tensor, I: torch.Tensor, distance: int) -> torch.Tensor:
    """scipy `_select_by_peak_distance` over [B, n]: the highest peaks claim
    their window first; a peak survives iff no kept peak lies within
    `distance`. Ties in height go to the LATER position (the JAX package's
    deterministic rule; it matches scipy wherever scipy's sort is stable).

    The priority order is a lexsort (height descending, then position
    descending) written as two stable sorts: by the secondary key first
    (position descending, the reversal), then by the primary. Every
    candidate ranks before every non-candidate, so the loop runs over the
    first `max_candidates(n)` ranks, whatever the data: a static count, as
    the JAX package's scan over all n ranks, with no read from the device
    (a CUDA graph replays it on any batch). `peak_mask` holds local maxima
    (`_local_maxima_mask`, gated), so it has no more candidates than that;
    a rank past a spectrum's candidates is not valid and changes nothing.

    The loop works in rank space: `near[b, k, j]` says whether ranks k and j
    lie within `distance`, and `blocked[b, j]` counts the kept ranks near
    rank j, so a rank takes two launches, its verdict and the count."""
    B, n = I.shape
    K = max_candidates(n)
    idx = torch.arange(n, device=I.device)
    priority = torch.where(peak_mask, I, -torch.inf)
    by_position = idx.flip(0).expand(B, n)
    order = by_position.gather(1, torch.argsort(-priority.flip(-1), dim=1, stable=True))
    pos = order[:, :K]  # [B, K]: distinct positions, the candidates first
    valid = peak_mask.gather(1, pos).to(torch.int32)
    near = ((pos[:, :, None] - pos[:, None, :]).abs() < distance).to(torch.int32)  # [B, K, K]
    kept = torch.zeros_like(valid)  # [B, K]: 1 where the rank survives
    blocked = torch.zeros_like(valid)  # [B, K]: kept ranks within `distance` so far
    for k in range(K):
        torch.gt(valid[:, k], blocked[:, k], out=kept[:, k])  # valid and not blocked
        blocked.addcmul_(near[:, k], kept[:, k:k + 1])
    keep = torch.zeros_like(peak_mask)
    return keep.scatter_(1, pos, kept.bool())


def find_peaks_device(I, height=0.05, distance=10, prominence=0.1, width=5,
                      max_peaks=MAX_PEAKS) -> Dict[str, torch.Tensor]:
    """scipy.find_peaks over spectra `[B, n]` (or one `[n]`) on their device
    (anything but a tensor goes to the card).

    Returns fixed-size padded tables, each `[B, max_peaks]` (`[max_peaks]`
    for one spectrum; n columns when n < max_peaks), peaks in index order:
    `valid` bool, `idx` int32, and `widths`, `heights`, `prominences` fp32
    (0 where not valid)."""
    I = as_device_tensor(I, None)
    single = I.dim() == 1
    I = (I[None] if single else I).float()
    # scipy.signal.find_peaks applies gates in order: height -> distance -> prominence -> width
    mask = _local_maxima_mask(I)
    mask &= I >= height
    DISTANCE_GATES.launches += 1
    with device_span("physics.distance_gate"):
        mask = _enforce_distance(mask, I, distance)
    prom = _prominences(I, mask)
    mask &= prom >= prominence
    w = _widths(I, mask, prom)
    mask &= w >= width

    # compact to a fixed-size table (stable order by index)
    n = I.shape[1]
    idx = torch.arange(n, device=I.device)
    order = torch.argsort(torch.where(mask, idx, n), dim=1, stable=True)[:, :max_peaks]
    valid = mask.gather(1, order)
    table = {
        "valid": valid,
        "idx": torch.where(valid, order, 0).to(torch.int32),
        "widths": torch.where(valid, w.gather(1, order), 0.0),
        "heights": torch.where(valid, I.gather(1, order), 0.0),
        "prominences": torch.where(valid, prom.gather(1, order), 0.0),
    }
    return {k: v[0] for k, v in table.items()} if single else table
