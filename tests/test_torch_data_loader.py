"""The port's data/loader.py and data/cropping.py against the JAX package's
copies, and data/images.py's bicubic resize against Pillow, on the CPU.

  * `DataModule`: the same batches in the same order, for one process and
    for each rank of two, with and without `multi_resolution` (the
    pool-constrained sampler), and with a `{target, params}` config;
  * cropping's resizing functions bit for bit, the originals resizing
    through Pillow (images) and OpenCV (depth maps), the port through
    neither (its pure-numpy functions: tests/test_torch_copies.py);
  * bicubic (and Lanczos) resizes equal to Pillow's, up and down, RGB and
    grayscale.
"""

import numpy as np
import pytest
from PIL import Image

from geo4d_tpu.core import config as jax_config
from geo4d_tpu.data import cropping as jax_cropping
from geo4d_tpu.data import loader as jax_loader
from geo4d_tpu_torch.core.registry import components
from geo4d_tpu_torch.data import cropping, loader
from geo4d_tpu_torch.data.images import bicubic_resize, lanczos_resize


class Clips:
    """An in-memory dataset of n samples over a pool of resolutions; with
    `takes_feat_idx` an item also depends on its batch's pool index."""

    _resolutions = [(32, 32), (48, 32), (64, 32)]

    def __init__(self, n=23, takes_feat_idx=False):
        self.n, self.takes_feat_idx = n, takes_feat_idx

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        i, feat = idx if isinstance(idx, tuple) else (idx, 0)
        w, h = self._resolutions[feat]
        return {"video": np.full((2, h // 16, w // 16, 3), i, np.float32), "fps": 24 - i % 5,
                "name": f"clip{i}", "meta": (i, float(i) / 2)}


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, str):
        assert got == want
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _batches(module, split, **kw):
    return list(module.loader(split, **kw))


@pytest.mark.parametrize("multi_resolution", [False, True])
@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1)])
def test_datamodule_matches_jax(multi_resolution, world, rank):
    ds = Clips(takes_feat_idx=multi_resolution)
    kw = dict(batch_size=3, train=ds, test=ds, test_max_n_samples=13,
              multi_resolution=multi_resolution, world_size=world, rank=rank)
    port, ref = loader.DataModule(**kw).setup(), jax_loader.DataModule(**kw).setup()
    for split, args in (("train", {"epoch": 0}), ("train", {"epoch": 5}), ("test", {})):
        got, want = _batches(port, split, **args), _batches(ref, split, **args)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_same(g, w)
    if world == 2:     # the ranks' batches are disjoint slices of one epoch plan
        other = loader.DataModule(**dict(kw, rank=1 - rank)).setup()
        mine = {int(v) for b in _batches(port, "train") for v in b["video"][:, 0, 0, 0, 0]}
        theirs = {int(v) for b in _batches(other, "train") for v in b["video"][:, 0, 0, 0, 0]}
        if not multi_resolution:
            assert mine == theirs          # without the sampler every rank reads the split
        else:
            assert not mine & theirs


def test_datamodule_config_and_aliases():
    name = "tests.ClipsForLoader"
    if name not in components:
        components.register(name)(lambda n, **_: Clips(n))
    if name not in jax_config.components:
        jax_config.components.register(name)(lambda n, **_: Clips(n))
    cfg = {"target": name, "params": {"n": 11}}
    port = loader.DataModule(batch_size=2, validation=cfg, predict=cfg)
    ref = jax_loader.DataModule(batch_size=2, validation=cfg, predict=cfg)
    for method in ("val_dataloader", "predict_dataloader"):
        got, want = list(getattr(port, method)()), list(getattr(ref, method)())
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _assert_same(g, w)


def test_prefetcher_passes_errors_on():
    def failing():
        yield 1
        raise KeyError("sample 2")

    it = loader.Prefetcher(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="sample 2"):
        next(it)


# ---------------- cropping ----------------

K = np.array([[120.0, 0.0, 61.3], [0.0, 118.0, 40.7], [0.0, 0.0, 1.0]])


def _view(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.uniform(0.5, 20.0, (h, w)).astype(np.float32))


def _same_view(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("hw,out", [((90, 120), (64, 48)),     # shrink: Lanczos
                                    ((45, 61), (160, 96)),     # grow: bicubic
                                    ((80, 130), (130, 60))])   # grow along one axis
def test_cropping_matches_jax(hw, out):
    img, depth = _view(*hw, seed=hw[0])
    _same_view(cropping.rescale_image_depthmap(img, depth, K, out),
               jax_cropping.rescale_image_depthmap(img, depth, K, out))
    _same_view(cropping.rescale_image_depthmap(img, None, K, out, force=False),
               jax_cropping.rescale_image_depthmap(img, None, K, out, force=False))
    _same_view(cropping.crop_resize_to(img, depth, K, out),
               jax_cropping.crop_resize_to(img, depth, K, out))


@pytest.mark.parametrize("hw,wh", [((97, 131), (50, 40)), ((31, 45), (200, 77)),
                                   ((64, 64), (64, 31)), ((7, 300), (301, 5))])
def test_resize_depth_matches_opencv(hw, wh):
    import cv2

    depth = _view(*hw, seed=1)[1]
    np.testing.assert_array_equal(cropping._resize_depth(depth, wh),
                                  cv2.resize(depth, wh, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("size,out", [((57, 83), (40, 29)), ((57, 83), (170, 120)),
                                      ((256, 576), (512, 300)), ((30, 20), (30, 47)),
                                      ((10, 10), (10, 10))])
@pytest.mark.parametrize("gray", [False, True])
def test_bicubic_and_lanczos_match_pillow(size, out, gray):
    rng = np.random.default_rng(size[0] + out[0])
    img = rng.integers(0, 256, size if gray else (*size, 3), dtype=np.uint8)
    for fn, res in ((bicubic_resize, Image.BICUBIC), (lanczos_resize, Image.LANCZOS)):
        want = np.asarray(Image.fromarray(img).resize(out, resample=res))
        got = fn(img, out)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
