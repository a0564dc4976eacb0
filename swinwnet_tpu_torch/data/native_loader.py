"""ctypes binding of the C++ prefetching batcher (port of
`swinwnet_tpu/data/native_loader.py`; the source is the port's own copy,
`data/csrc/batcher.cpp`).

The library is compiled with g++ at first use into `data/csrc/build/`, keyed
by the hash of the source and the flags, and loaded with ctypes. It yields
what `ArrayLoader` yields -- (images [B,1,H,W], masks [B,H,W]) numpy batches
with len() -- with the batch assembly (index gather and the noise protocols)
in a C++ worker thread that stays one batch ahead of the trainer. When the
library does not build, `NativeBatcher.available()` is False and the
constructor raises: nothing falls back to `ArrayLoader` quietly.

Noise semantics match `data/noise.py`: one mu ~ U(*noise_mu_range) draw per
batch, additive N(mu, sigma_frac * mu) per pixel -- the train augmentation is
the default range (0, 150); the published eval protocol N(100, 20) is
noise_mu_range=(100, 100). The streams are C++ std::mt19937_64, so sample
values differ from the numpy loader's; the same source, flags and seed give
the JAX package's `NativeBatcher` stream bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "batcher.cpp"
BUILD_DIR = _SRC.parent / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile csrc/batcher.cpp into BUILD_DIR unless that library exists;
    returns its path. Raises RuntimeError with the compiler's message."""
    key = hashlib.sha1(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libbatcher_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native batcher needs g++ to build: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) on {_SRC}:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    """The built library with its signatures set; raises when it does not
    build or load."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError) as e:
                raise RuntimeError(f"native batcher unavailable: {e}") from e
            F, I64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            lib.batcher_create.restype = ctypes.c_void_p
            lib.batcher_create.argtypes = [
                F, F, I64, I64, I64, I64, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_uint64,
            ]
            lib.batcher_next.restype = I64
            lib.batcher_next.argtypes = [ctypes.c_void_p, F, F]
            lib.batcher_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeBatcher:
    """Iterator of ([B,1,H,W] images, [B,H,W] masks) with C++ prefetch.

    Takes `ArrayLoader`'s place in the trainers (`for images, masks in
    loader` once per epoch): each `__iter__` yields one epoch's worth of
    batches from an endless, internally reshuffling stream. The arrays a
    batch returns are fresh, so the worker's reuse of its buffers cannot
    reach them.
    """

    def __init__(
        self,
        images: np.ndarray,
        masks: Optional[np.ndarray] = None,
        batch_size: int = 8,
        shuffle: bool = True,
        add_noise: bool = False,
        noise_mu_range: Tuple[float, float] = (0.0, 150.0),
        sigma_frac: float = 0.2,
        seed: int = 0,
    ):
        self._lib = _load()
        # the worker reads these for the handle's lifetime: keep them alive
        self._images = np.ascontiguousarray(images, dtype=np.float32)
        if self._images.ndim == 4:
            self._images = np.ascontiguousarray(self._images[:, 0])
        self._masks = None if masks is None else np.ascontiguousarray(masks, dtype=np.float32)
        N, H, W = self._images.shape
        self.batch_size = batch_size
        self.N, self.H, self.W = N, H, W
        self._handle = self._lib.batcher_create(
            _fptr(self._images),
            None if self._masks is None else _fptr(self._masks),
            N, H, W, batch_size, int(shuffle), int(add_noise),
            float(noise_mu_range[0]), float(noise_mu_range[1]), float(sigma_frac), seed,
        )

    @staticmethod
    def available() -> bool:
        """Whether the library builds (and loads) here."""
        try:
            _load()
        except RuntimeError:
            return False
        return True

    @property
    def n_samples(self) -> int:
        return self.N

    @property
    def batches_per_epoch(self) -> int:
        return (self.N + self.batch_size - 1) // self.batch_size

    def next(self) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
        """(images [batch,1,H,W], masks [batch,H,W] or None, real samples):
        a short last batch of an epoch is zero-padded to `batch_size`."""
        imgs = np.empty((self.batch_size, 1, self.H, self.W), np.float32)
        msks = np.empty((self.batch_size, self.H, self.W), np.float32)
        n = self._lib.batcher_next(self._handle, _fptr(imgs), _fptr(msks))
        return imgs, (msks if self._masks is not None else None), int(n)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        for _ in range(self.batches_per_epoch):
            imgs, msks, n = self.next()
            yield imgs[:n], (msks[:n] if msks is not None else None)

    def __len__(self) -> int:
        return self.batches_per_epoch

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.batcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
