"""The port's training-mode models against the JAX package's: YOLOv5n (4
classes, 64 px) and SSDLite (8 classes + background, 64 px, the full
MobileNet tail), batch 2, weights carried from the JAX init.

Tolerances and why:
  * YOLOv5n train-mode heads: within 1e-4 of each output's largest value
    (XLA's and PyTorch's CPU convolutions sum in different orders).
  * SSDLite train-mode heads: the rows of the 4x4 and 2x2 levels within
    1e-4 of each output's largest value; the rows of the four 1x1 levels
    within 5e-2. At 64 px the four extra blocks run on 1x1 maps, where
    batch-2 BatchNorm normalises two values (each output is +-(a - b) /
    sqrt((a - b)^2 + 4 eps)): the function is ill-conditioned there, and
    the JAX package's own outputs move by more than 1e-4 of their largest
    value when its input moves by 1e-7 relative (checked below). A wrong
    formula moves them by O(1).
  * new running stats: within 1e-5 of max(1, each tensor's largest
    |value|); in SSDLite, the BatchNorms fed by a batch-2 1x1 BatchNorm
    (the extra blocks after the first depthwise conv, the heads' 1x1
    levels) inherit its conditioning: 5e-4 there (4.6e-5 measured).
  * ``to_jax_params`` after ``from_jax_params``: the same trees, bit for
    bit.
  * the eval path: bit for bit unchanged by a training forward, apart from
    the running stats it updates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models.ssdlite import SSDLite as JaxSSDLite
from edgeml_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from edgeml_tpu_torch.models.ssdlite import SSDLite
from edgeml_tpu_torch.models.yolov5 import YoloV5

torch.set_num_threads(1)

HEAD_TOL = 1e-4
SSD_1X1_ROWS_TOL = 5e-2
STATS_TOL = 1e-5
SSD_1X1_STATS_TOL = 5e-4
SSD_FRONT_ROWS = (4 * 4 + 2 * 2) * 6  # the levels whose BatchNorms see >= 8


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _images(seed, b=2, s=64):
    return np.random.default_rng(seed).random((b, s, s, 3)).astype(np.float32)


def _rel(a, b):
    a, b = (t.detach().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for t in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


def _stats_errs(got, want):
    """{tree path: error over max(1, largest |value|)} of each stats leaf."""
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    want = jax.tree_util.tree_leaves(_np(want))
    assert len(flat) == len(want)
    return {jax.tree_util.keystr(path): float(
        np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))
        for (path, a), b in zip(flat, want)}


def _stats_err(got, want):
    return max(_stats_errs(got, want).values())


def _after_1x1_bn(path):
    """SSDLite at 64 px: a BatchNorm downstream of the first batch-2 one on
    a 1x1 map (extra block 0's depthwise conv)."""
    return path.startswith(("['extra'][0]['expand']", "['extra'][1]",
                            "['extra'][2]", "['extra'][3]")) or any(
        path.startswith(f"['{h}'][{i}]") for h in ("cls_head", "reg_head")
        for i in range(2, 6))


@pytest.fixture(scope="module")
def yolo():
    jnet = JaxYoloV5(variant="n", num_classes=4, img_size=64)
    params, stats = jnet.init(jax.random.PRNGKey(0))
    x = _images(1)
    heads, new_stats, _ = jax.jit(
        lambda p, s, x: jnet.apply(p, s, x, train=True))(
            params, stats, jnp.asarray(x))
    return dict(params=_np(params), stats=_np(stats), x=x,
                heads=[np.asarray(h) for h in heads],
                new_stats=_np(new_stats))


@pytest.fixture(scope="module")
def ssd():
    jnet = JaxSSDLite(num_classes=9, image_size=64)
    params, stats = jnet.init(jax.random.PRNGKey(1))
    x = _images(2)
    fwd = jax.jit(lambda p, s, x: jnet.apply(p, s, x, train=True))
    (cls, reg), new_stats = fwd(params, stats, jnp.asarray(x))
    rng = np.random.default_rng(3)
    x2 = (x * (1 + rng.normal(0, 1e-7, x.shape))).astype(np.float32)
    (cls2, reg2), _ = fwd(params, stats, jnp.asarray(x2))
    return dict(params=_np(params), stats=_np(stats), x=x,
                out=(np.asarray(cls), np.asarray(reg)),
                moved=(np.asarray(cls2), np.asarray(reg2)),
                new_stats=_np(new_stats))


def test_yolo_train_heads_and_stats_match_jax(yolo):
    net = YoloV5("n", 4, 64).from_jax_params(yolo["params"], yolo["stats"])
    net.train()
    heads, stats = net.train_forward(torch.from_numpy(yolo["x"]))
    assert len(heads) == 3
    for got, want in zip(heads, yolo["heads"]):
        assert got.dtype == torch.float32
        assert tuple(got.shape) == want.shape  # (B, H, W, na, no)
        assert _rel(got, want) < HEAD_TOL
    assert len(stats) == 2 * sum(1 for m in net.modules()
                                 if isinstance(m, torch.nn.BatchNorm2d))
    err = _stats_err(net.to_jax_params()[1], yolo["new_stats"])
    print(f"yolo stats err {err:.3e}")
    assert err < STATS_TOL


def test_ssd_train_heads_and_stats_match_jax(ssd):
    net = SSDLite(9, 64).from_jax_params(ssd["params"], ssd["stats"])
    net.train()
    (cls, reg), _ = net.train_forward(torch.from_numpy(ssd["x"]))
    for got, want, moved in zip((cls, reg), ssd["out"], ssd["moved"]):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        err = np.abs(got.detach().numpy() - want)
        front = float(err[:, :SSD_FRONT_ROWS].max() / np.abs(want).max())
        back = float(err[:, SSD_FRONT_ROWS:].max() / np.abs(want).max())
        own = float(np.abs(moved - want).max() / np.abs(want).max())
        print(f"ssd front {front:.3e} 1x1 levels {back:.3e} "
              f"jax-own {own:.3e}")
        assert front < HEAD_TOL
        assert back < SSD_1X1_ROWS_TOL
        assert own > HEAD_TOL  # why the 1x1 levels get the looser bound
    errs = _stats_errs(net.to_jax_params()[1], ssd["new_stats"])
    front = max(e for p, e in errs.items() if not _after_1x1_bn(p))
    back = max(e for p, e in errs.items() if _after_1x1_bn(p))
    print(f"ssd stats err {front:.3e}, after the 1x1 BatchNorm {back:.3e}")
    assert front < STATS_TOL
    assert back < SSD_1X1_STATS_TOL


@pytest.mark.parametrize("family", ["yolo", "ssd"])
def test_to_jax_params_inverts_from_jax_params(family, yolo, ssd):
    ref = yolo if family == "yolo" else ssd
    net = YoloV5("n", 4, 64) if family == "yolo" else SSDLite(9, 64)
    net.from_jax_params(ref["params"], ref["stats"])
    got = net.to_jax_params()
    want = (ref["params"], ref["stats"])
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("family", ["yolo", "ssd"])
def test_eval_path_unchanged_by_training_forward(family, yolo, ssd):
    """An eval pass reads the running stats and writes nothing; after a
    training forward the eval outputs are those of a fresh module loaded
    with the new stats, bit for bit; with the old stats put back, those of
    before."""
    ref = yolo if family == "yolo" else ssd
    make = (lambda: YoloV5("n", 4, 64)) if family == "yolo" \
        else (lambda: SSDLite(9, 64))
    x = torch.from_numpy(ref["x"])

    def serve(m):
        with torch.no_grad():
            return m.predict(x) if family == "yolo" else m(x)

    net = make().from_jax_params(ref["params"], ref["stats"])
    before = serve(net)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    again = serve(net)
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    net.train()
    net.train_forward(x)
    net.eval()
    fresh = make().from_jax_params(*net.to_jax_params())
    for a, b in zip(serve(net), serve(fresh)):
        assert torch.equal(a, b)
    net.from_jax_params(ref["params"], ref["stats"])
    for a, b, c in zip(serve(net), before, again):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_train_forward_needs_train_mode():
    with pytest.raises(RuntimeError, match="train"):
        YoloV5("n", 4, 64).train_forward(torch.zeros(1, 64, 64, 3))
    with pytest.raises(RuntimeError, match="train"):
        SSDLite(9, 64).train_forward(torch.zeros(1, 64, 64, 3))


def test_bf16_train_forward_keeps_f32_stats_and_grads(yolo):
    """bf16 compute: heads come back f32, BatchNorm stats stay f32 and near
    the f32 pass's, gradients land on the f32 master weights. bf16 keeps 8
    mantissa bits through ~60 layers and promises no exactness: heads
    within 0.25 of their largest value (0.136 measured), stats 0.05."""
    x = torch.from_numpy(yolo["x"])
    nets = {}
    for dt in (None, torch.bfloat16):
        net = YoloV5("n", 4, 64).from_jax_params(yolo["params"],
                                                  yolo["stats"])
        net.train()
        heads, stats = net.train_forward(x, dtype=dt)
        assert all(h.dtype == torch.float32 for h in heads)
        assert all(v.dtype == torch.float32 for v in stats.values())
        sum(h.sum() for h in heads).backward()
        w = net.model[0].conv.weight
        assert w.dtype == torch.float32 and w.grad.dtype == torch.float32
        nets[dt] = (net, heads)
    (n32, h32), (n16, h16) = nets[None], nets[torch.bfloat16]
    for a, b in zip(h16, h32):
        assert _rel(a, b) < 0.25
    err = _stats_err(n16.to_jax_params()[1], n32.to_jax_params()[1])
    assert err < 0.05
