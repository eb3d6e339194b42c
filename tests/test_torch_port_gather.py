"""The port's row gather (``ops/gather.py``) against the JAX package's Pallas
row-gather kernel (``tools/gather_pallas_kernel.py``, run in interpret mode
and loaded by file path, since ``tools/`` is not a package).

Cases: f32 and bf16 sources, unscaled and scaled (every promotion of the
two types), int32 and int64 indices, channel widths 1 / 3 / 4 / 80 / 91, and
a source over the kernel's 7 MB block (25,200 x 80 f32) that takes its
multi-chunk path. Tolerance: none, bit for bit; the outputs' dtypes equal.
Also the CUDA wrapper's choice between its two kernels, a pure function of
types, width, strides and addresses.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgeml_tpu_torch.ops import nms as tnms
from edgeml_tpu_torch.ops.gather import (
    gather_rows, gather_rows_cuda, gather_rows_plain, vector_path,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_kernel():
    path = os.path.join(REPO, "tools", "gather_pallas_kernel.py")
    spec = importlib.util.spec_from_file_location("gather_pallas_kernel",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.gather_rows


JAX_GATHER = _jax_kernel()
DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                  jnp.bfloat16)}


def _case(seed, b, n, c, k, src_dt, scale_dt):
    rng = np.random.default_rng(seed)
    src = rng.normal(0, 1, (b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    idx[:, :3] = [0, n - 1, n - 1]  # both ends, and a repeat
    scale = None if scale_dt is None else rng.random((b, n)).astype(
        np.float32)
    t_src = torch.from_numpy(src).to(DT[src_dt][0])
    t_scale = None if scale is None else torch.from_numpy(scale).to(
        DT[scale_dt][0])
    j_src = jnp.asarray(src, DT[src_dt][1])
    j_scale = None if scale is None else jnp.asarray(scale, DT[scale_dt][1])
    return (t_src, torch.from_numpy(idx), t_scale), (j_src, jnp.asarray(idx),
                                                     j_scale)


def _equal(got, want):
    want = np.asarray(want)
    assert str(got.dtype) == f"torch.{want.dtype}"  # float32 / bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("src_dt,scale_dt", [
    ("f32", None), ("bf16", None), ("f32", "f32"), ("bf16", "bf16"),
    ("bf16", "f32"), ("f32", "bf16")])
@pytest.mark.parametrize("c", [4, 80, 91])
def test_plain_matches_interpret_mode_kernel(src_dt, scale_dt, c):
    t_args, j_args = _case(c, 2, 3000, c, 512, src_dt, scale_dt)
    want = JAX_GATHER(*j_args, interpret=True)
    got = gather_rows(*t_args)
    assert got.shape == (2, 512, c)
    _equal(got, want)
    # int64 indices give the same rows
    _equal(gather_rows_plain(t_args[0], t_args[1].long(), t_args[2]), want)


@pytest.mark.parametrize("scaled", [False, True])
def test_plain_matches_kernel_multi_chunk(scaled):
    """YOLOv5's tail source (25,200 rows of 80 f32): 10.3 MB, two of the
    TPU kernel's 7 MB blocks."""
    t_args, j_args = _case(7, 1, 25200, 80, 64, "f32",
                           "f32" if scaled else None)
    want = JAX_GATHER(*j_args, interpret=True)
    _equal(gather_rows(*t_args), want)


def test_broadcast_and_strided_sources():
    """An expanded source (image stride 0, Faster R-CNN's anchors) and a
    channel slice (row stride > C, SSD's scores) gather as their copies
    do."""
    rng = np.random.default_rng(3)
    anc = torch.from_numpy(rng.random((500, 4)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 500, (3, 64)))
    got = gather_rows(anc.expand(3, -1, -1), idx)
    assert torch.equal(got, gather_rows(anc.expand(3, -1, -1).contiguous(),
                                        idx))
    assert torch.equal(got[1], anc[idx[1]])
    wide = torch.from_numpy(rng.random((3, 500, 91)).astype(np.float32))
    assert torch.equal(gather_rows(wide[..., 1:], idx),
                       gather_rows(wide[..., 1:].contiguous(), idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scaled_gather_equals_gather_then_multiply(dtype):
    """The YOLOv5 tail's cls_conf: one scaled gather equals the earlier
    gather of the class rows times the gathered objectness, bit for bit, in
    f32 and in bf16 (one rounding of the f32 product)."""
    rng = np.random.default_rng(4)
    cls = torch.from_numpy(rng.random((2, 2000, 80)).astype(np.float32)).to(
        dtype)
    obj = torch.from_numpy(rng.random((2, 2000)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 2000, (2, 300)))
    old = cls.gather(1, idx[..., None].expand(2, 300, 80)) \
        * obj.gather(1, idx)[..., None]
    got = tnms.gather_rows(cls, idx, scale=obj)
    assert got.dtype == dtype and torch.equal(got, old)


@pytest.mark.parametrize("src_dt,scale_dt", [
    ("f32", None), ("bf16", None), ("f32", "f32"), ("bf16", "bf16"),
    ("bf16", "f32"), ("f32", "bf16")])
@pytest.mark.parametrize("c", [1, 3])
def test_plain_matches_interpret_mode_kernel_narrow_rows(src_dt, scale_dt, c):
    """C = 1 (``nms_rows``' class-id gather) and an odd C: the rows the CUDA
    wrapper moves an element a thread."""
    t_args, j_args = _case(20 + c, 2, 3000, c, 512, src_dt, scale_dt)
    want = JAX_GATHER(*j_args, interpret=True)
    got = gather_rows(*t_args)
    assert got.shape == (2, 512, c)
    _equal(got, want)


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize(
    "src_dt,scale_dt,c,image_stride,row_stride,src_ptr,out_ptr,want", [
        (F32, None, 4, 360000, 4, 4096, 8192, True),  # nms_rows: 1 vector
        (F32, F32, 80, 2016000, 80, 4096, 8192, True),  # YOLOv5 f32: 20
        (BF16, BF16, 80, 2016000, 80, 4096, 8192, True),  # 160-byte rows: 10
        (BF16, None, 8, 0, 8, 16, 32, True),  # one vector, broadcast image
        (F32, None, 4, 0, 0, 4096, 8192, True),  # both strides 0
        (F32, None, 8, 2400, 96, 4096 + 16, 8192, True),  # an aligned slice
        (F32, None, 1, 90000, 1, 4096, 8192, False),  # 4-byte rows
        (F32, None, 3, 2700, 3, 4096, 8192, False),  # 12-byte rows
        (F32, None, 91, 81900, 91, 4096, 8192, False),  # 364-byte rows
        (BF16, None, 4, 3600, 4, 4096, 8192, False),  # 8-byte rows
        (BF16, None, 84, 75600, 84, 4096, 8192, False),  # 168-byte rows
        (F32, None, 4, 360000, 4, 4096 + 4, 8192, False),  # base off by one
        (BF16, None, 8, 7200, 8, 4096 + 2, 8192, False),
        (F32, None, 4, 360000, 4, 4096, 8192 + 8, False),  # output unaligned
        (F32, None, 4, 360002, 4, 4096, 8192, False),  # image stride 8 mod 16
        (F32, None, 4, 360000, 91, 4096, 8192, False),  # row stride 364 B
        (BF16, None, 8, 7200, 12, 4096, 8192, False),  # row stride 24 B
        (BF16, F32, 80, 2016000, 80, 4096, 8192, False),  # mixed types
        (F32, BF16, 80, 2016000, 80, 4096, 8192, False),
    ])
def test_vector_path_is_exactly_16_byte_alignment(src_dt, scale_dt, c,
                                                  image_stride, row_stride,
                                                  src_ptr, out_ptr, want):
    """The 16-byte kernel exactly when source and scale share a type and a
    row's bytes, both strides' bytes and both addresses are multiples of
    16."""
    assert vector_path(src_dt, scale_dt, c, image_stride, row_stride,
                       src_ptr, out_ptr) is want


def test_vector_path_of_real_views():
    """The choice from real tensors' strides and addresses: an offset view
    and a channel slice leave the 16-byte grid, an expanded source and an
    aligned slice stay on it."""
    def path(t):
        return vector_path(t.dtype, None, t.shape[2], t.stride(0),
                           t.stride(1), t.data_ptr(), 0)

    flat = torch.zeros(2 * 50 * 4 + 1)
    assert flat.data_ptr() % 16 == 0
    assert path(flat[:-1].view(2, 50, 4))
    assert not path(flat[1:].view(2, 50, 4))
    wide = torch.zeros(2, 50, 96)
    assert path(wide[..., 4:12]) and not path(wide[..., 3:11])
    assert not path(wide[..., 1:])  # 95 channels
    assert path(torch.zeros(50, 4).expand(2, -1, -1))
    assert path(torch.zeros(2, 50, 80, dtype=torch.bfloat16))
    assert not path(torch.zeros(2, 50, 1))


def test_cuda_wrapper_refuses_cpu_tensors():
    before = gather_rows_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows_cuda(torch.zeros(1, 8, 4),
                         torch.zeros(1, 2, dtype=torch.int64))
    assert gather_rows_cuda.launches == before
