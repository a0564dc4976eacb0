"""The port's data feed (swinwnet_tpu_torch/data/) against the JAX
package's: the same seeds give the same arrays, bit for bit (both are
numpy), for the synthetic renderer with each of its effects, the dataset
maker, the evaluation noise, the two augmentation factories, the loaders of
files and `ArrayLoader` (shuffle, drop_last, augment, joint_augment); and a
port trainer takes the port's loader."""

import pickle

import numpy as np
import pytest
import torch

from swinwnet_tpu.data import generation as jgen
from swinwnet_tpu.data import loaders as jloaders
from swinwnet_tpu.data import noise as jnoise
from swinwnet_tpu_torch import data
from swinwnet_tpu_torch.data import generation, loaders, noise

torch.set_num_threads(1)

RENDER_KW = [
    dict(seed=0),
    dict(seed=None, background=0.0),
    dict(seed=3, direct_beam=4.0, speckle_k=3.0),
    dict(seed=5, theta_mod=0.4, pedestal=0.1, tof_tail=0.05, H=60, W=80),
]


@pytest.mark.parametrize("kw", RENDER_KW, ids=["poisson", "clean", "beam+speckle", "arcs+pedestal+tail"])
def test_synthesize_pattern_same_arrays(kw):
    d, inten = [1.1, 2.3, 3.7], [1.0, 0.6, 2.0]
    kw = {"H": 50, "W": 96, **kw}
    got = generation.synthesize_pattern(d, inten, **kw)
    want = jgen.synthesize_pattern(d, inten, **kw)
    assert got.dtype == np.float32 and got.shape == (kw["H"], kw["W"])
    np.testing.assert_array_equal(got, want)


def test_synthesize_dataset_and_d_lists_same_arrays():
    got = generation.synthesize_dataset(3, H=40, W=48, seed=4)
    want = jgen.synthesize_dataset(3, H=40, W=48, seed=4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[1].dtype == np.uint8 and got[1].any()
    np.testing.assert_array_equal(generation.sample_d_list(np.random.default_rng(1), 6),
                                  jgen.sample_d_list(np.random.default_rng(1), 6))


def test_noise_and_augments_same_arrays():
    x = np.random.default_rng(0).uniform(0, 1e3, (4, 1, 20, 24)).astype(np.float32)
    m = (x[:, 0] > 500).astype(np.float32)
    np.testing.assert_array_equal(noise.add_eval_noise(x, seed=2), jnoise.add_eval_noise(x, seed=2))
    got = noise.make_train_noise_augment()(np.random.default_rng(3), x)
    np.testing.assert_array_equal(got, jnoise.make_train_noise_augment()(np.random.default_rng(3), x))
    gi, gm = noise.make_theta_flip_augment(0.5)(np.random.default_rng(4), x, m)
    wi, wm = jnoise.make_theta_flip_augment(0.5)(np.random.default_rng(4), x, m)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gm, wm)
    assert not np.array_equal(gi, x)  # something was flipped


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_array_loader_same_batches(shuffle, drop_last):
    images, masks = generation.synthesize_dataset(7, H=20, W=24, seed=2)
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=9)
    got = loaders.ArrayLoader(images, masks, augment=noise.make_train_noise_augment(),
                              joint_augment=noise.make_theta_flip_augment(), **kw)
    want = jloaders.ArrayLoader(images, masks, augment=jnoise.make_train_noise_augment(),
                                joint_augment=jnoise.make_theta_flip_augment(), **kw)
    assert len(got) == len(want) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs: fresh shuffles and noise, the same on both sides
        batches = list(got)
        assert len(batches) == len(want)
        for (gi, gm), (wi, wm) in zip(batches, want):
            assert gi.shape[1] == 1
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)


def test_file_loaders_same_arrays(tmp_path):
    rng = np.random.default_rng(5)
    arr = rng.uniform(size=(25, 48)).astype(np.float32)
    np.save(tmp_path / "plain.npy", arr)
    np.save(tmp_path / "dict.npy", np.array({"image": arr}, dtype=object), allow_pickle=True)
    for name in ("plain.npy", "dict.npy"):
        np.testing.assert_array_equal(loaders.load_crystal_npy(str(tmp_path / name)),
                                      jloaders.load_crystal_npy(str(tmp_path / name)))
    rows = [{"Matrix": rng.uniform(size=(5, 6)), "Mask": rng.uniform(size=(5, 6)) > 0.5, "Crystal": c,
             "Stats": 1e8, "Pulce duration": 10.0} for c in ("Si", "Rb", "UO2")]
    with open(tmp_path / "rows.pkl", "wb") as f:
        pickle.dump(rows, f)
    got = loaders.load_dataset_pickle(str(tmp_path / "rows.pkl"), crystals=("Si", "UO2"))
    want = jloaders.load_dataset_pickle(str(tmp_path / "rows.pkl"), crystals=("Si", "UO2"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and len(got[2]) == 2
    gm, gmeta = loaders.load_segmentation_maps(str(tmp_path / "rows.pkl"))
    wm, wmeta = jloaders.load_segmentation_maps(str(tmp_path / "rows.pkl"))
    np.testing.assert_array_equal(gm, wm)
    assert gmeta == wmeta


def test_a_port_trainer_takes_the_port_loader():
    from swinwnet_tpu_torch.models import SwinWNet
    from swinwnet_tpu_torch.train import SegmentatorTrainer

    images, masks = data.synthesize_dataset(2, H=20, W=30, seed=1)
    loader = data.ArrayLoader(images, masks, batch_size=2, joint_augment=data.make_theta_flip_augment())
    model = SwinWNet(embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3), error_matrix=True,
                     device="cpu").train()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    trainer = SegmentatorTrainer(model, loader, num_epochs=1, warmup_epochs=1, verbose=False)
    hist = trainer.train()
    assert np.isfinite(hist["train_loss"]).all() and len(hist["train_loss"]) == 1
    assert not torch.equal(before["patch_embed.proj.weight"], model.patch_embed.proj.weight)
