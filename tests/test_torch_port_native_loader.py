"""The port's C++ prefetching batcher (`data/native_loader.py` over its own
copy of the source, `data/csrc/batcher.cpp`) against the JAX package's
`NativeBatcher`: the same arguments and seed give the same batches bit for
bit; and the JAX file's protocol tests (tests/test_native_loader.py) on the
port. The JAX library is built here into a temporary directory, so this
file never writes the JAX package's own build output."""

import shutil

import numpy as np
import pytest

import swinwnet_tpu.data.native_loader as jax_native
import swinwnet_tpu_torch.data.native_loader as native
from swinwnet_tpu_torch.data import ArrayLoader, NativeBatcher

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the native batcher")


@pytest.fixture(scope="module")
def jax_batcher(tmp_path_factory):
    """The JAX `NativeBatcher`, its library built from the JAX source with
    the same flags into a temporary directory."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_native, "_LIB", str(tmp_path_factory.mktemp("jaxlib") / "libbatcher.so"))
    patch.setattr(jax_native, "_lib", None)
    assert jax_native.NativeBatcher.available()
    yield jax_native.NativeBatcher
    patch.undo()


def data(n=10, h=8, w=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 100, (n, h, w)).astype(np.float32),
            (rng.uniform(size=(n, h, w)) > 0.5).astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=False),
    dict(batch_size=4, shuffle=True, seed=3),
    dict(batch_size=3, shuffle=True, add_noise=True, seed=7),
    dict(batch_size=4, shuffle=False, add_noise=True, noise_mu_range=(100.0, 100.0), sigma_frac=0.2, seed=1),
    dict(batch_size=5, shuffle=True, add_noise=True, noise_mu_range=(10.0, 60.0), sigma_frac=0.5, seed=11),
])
@pytest.mark.parametrize("with_masks", [True, False])
def test_same_stream_as_the_jax_batcher(jax_batcher, kw, with_masks):
    images, masks = data()
    masks = masks if with_masks else None
    port, ref = NativeBatcher(images, masks, **kw), jax_batcher(images, masks, **kw)
    try:
        assert len(port) == len(ref)
        for _ in range(3 * len(ref) + 1):  # across epochs and their reshuffles
            (pi, pm, pn), (ji, jm, jn) = port.next(), ref.next()
            assert pn == jn
            np.testing.assert_array_equal(pi, ji)
            assert (pm is None) == (jm is None) == (masks is None)
            if pm is not None:
                np.testing.assert_array_equal(pm, jm)
        for (pi, pm), (ji, jm) in zip(port, ref):  # one epoch through __iter__
            np.testing.assert_array_equal(pi, ji)
    finally:
        port.close()
        ref.close()


def test_matches_python_semantics():
    images, masks = data()
    nb = NativeBatcher(images, masks, batch_size=4, shuffle=False)
    assert len(nb) == 3 and nb.n_samples == 10
    batches = list(nb)
    nb.close()
    assert batches[0][0].shape == (4, 1, 8, 12) and batches[2][0].shape == (2, 1, 8, 12)
    ref = list(ArrayLoader(images, masks, batch_size=4))
    for (pi, pm), (ri, rm) in zip(batches, ref):
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pm, rm)


def test_eval_noise_protocol():
    """mu_lo == mu_hi == 100, sigma_frac 0.2 reproduces N(100, 20)."""
    nb = NativeBatcher(np.zeros((4, 64, 64), np.float32), None, batch_size=4, shuffle=False, add_noise=True,
                       noise_mu_range=(100.0, 100.0), sigma_frac=0.2, seed=1)
    imgs, msks, n = nb.next()
    nb.close()
    assert n == 4 and msks is None
    assert abs(imgs.mean() - 100.0) < 2.0
    assert abs(imgs.std() - 20.0) < 2.0


def test_train_noise_randomized_mu():
    """Per-batch mu ~ U(0, 150): batches see different mu levels, and the
    same seed reproduces the same stream."""
    images = np.zeros((32, 32, 32), np.float32)

    def stream(seed):
        nb = NativeBatcher(images, None, batch_size=4, shuffle=False, add_noise=True,
                           noise_mu_range=(0.0, 150.0), seed=seed)
        out = [nb.next()[0] for _ in range(8)]
        nb.close()
        return out

    a, b = stream(7), stream(7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], stream(8)[0])
    mus = np.array([x.mean() for x in a])
    assert mus.std() > 10.0
    assert 0.0 <= mus.min() and mus.max() <= 160.0


def test_shuffle_covers_all():
    nb = NativeBatcher(np.arange(8, dtype=np.float32).reshape(8, 1, 1), None, batch_size=8, shuffle=True, seed=2)
    imgs, _, n = nb.next()
    nb.close()
    assert n == 8
    np.testing.assert_array_equal(np.sort(imgs[:, 0, 0, 0]), np.arange(8))


def test_raises_when_it_cannot_build(monkeypatch, tmp_path):
    """No quiet fallback: a source that does not compile makes `available()`
    False and the constructor raise with the compiler's message."""
    bad = tmp_path / "batcher.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert not NativeBatcher.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        NativeBatcher(np.zeros((2, 4, 4), np.float32))


def test_feeds_a_trainer_epoch():
    """The batcher takes ArrayLoader's place in a trainer: one stage-1 epoch
    of the tiny SwinWNet on the CPU."""
    import torch

    from swinwnet_tpu_torch.models import SwinWNet
    from swinwnet_tpu_torch.train import SegmentatorTrainer

    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1e3, (6, 20, 30)).astype(np.float32)
    masks = (rng.uniform(size=(6, 20, 30)) > 0.6).astype(np.float32)
    model = SwinWNet(embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3), error_matrix=True, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    loader = NativeBatcher(images, masks, batch_size=4, add_noise=True, seed=0)
    trainer = SegmentatorTrainer(model, loader, num_epochs=1, warmup_epochs=1, verbose=False)
    hist = trainer.train()
    loader.close()
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0])
