"""The port's process layer (``parallel/mesh.py``), the meters' and the
evaluator's merges across processes, on the CPU.

One spawn of two gloo ranks (``torch_mp_worker.py surface``) checks the
group's bring-up, ``allgather_object`` on ragged payloads in rank order, ``all_sum``,
``shard_along``,
``replicate``, the meter sum (the expectations of the JAX package's
``tests/mp_worker.py``: rank r adds r + 1 with weight r + 1) and the
evaluator merge; here, the merged APs equal one process's over the union
of the ranks' images bit for bit, in both styles. The one-process
behaviour (every helper a no-op) and the backend choice from the layout
are checked without a spawn.
"""

import pickle

import numpy as np
import pytest
import torch

from edgeml_tpu_torch.eval_coco import DetectionEvaluator
from edgeml_tpu_torch.parallel import mesh
from edgeml_tpu_torch.parallel.meters import MetricLogger, SmoothedValue

from torch_mp_worker import NPROC, eval_images_of, spawn

torch.set_num_threads(1)

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture(scope="module")
def surface(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    outs = spawn("surface", root)
    ranks = []
    for r in range(NPROC):
        with open(root / f"surface_{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return outs, ranks


def _union():
    imgs = [im for r in range(NPROC) for im in eval_images_of(r)]
    return [d for d, _ in imgs], [g for _, g in imgs]


def test_two_ranks_bring_up_gloo_and_print_it_once(surface):
    outs, _ = surface
    line = "[distributed] backend=gloo world_size=2 (ranks on the CPU)"
    assert [line in o for o in outs] == [True, False]


@pytest.mark.parametrize("style", ["greedy", "coco"])
def test_merged_evaluator_equals_one_process_over_the_union(surface, style):
    _, ranks = surface
    dets, gts = _union()
    ev = DetectionEvaluator(device="cpu") if style == "greedy" \
        else DetectionEvaluator(style="coco")
    ev.update(dets, gts)
    want = ev.summarize(verbose=False)
    for got in ranks:
        assert got["n_dets"] == len(dets)
        # the gathered images come in rank order
        assert got["first"] == [float(d[2][0]) for d in dets]
        merged = got[style]
        assert set(merged) == set(want)
        for k, v in want.items():  # bit for bit, NaN where NaN
            np.testing.assert_array_equal(merged[k], v, err_msg=k)


def test_one_process_is_a_no_op(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    mesh.initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_primary()
    assert mesh.allgather_object({"a": 1}) == [{"a": 1}]
    t = torch.arange(4.0)
    assert mesh.all_sum(t) is t and mesh.all_sum(3) == 3
    assert mesh.shard_along(t) is not None and torch.equal(
        mesh.shard_along(t), t)
    lin = torch.nn.Linear(2, 2)
    assert mesh.replicate(lin) is lin and mesh.replicate({"x": 1}) == {"x": 1}
    assert mesh.pad_to_multiple(9, 4) == 12
    v = SmoothedValue()
    v.update(2.0, n=3)
    v.synchronize_between_processes()
    assert (v.count, v.total) == (3, 6.0)
    log = MetricLogger()
    log.update(loss=1.5)
    log.synchronize_between_processes()
    assert log.loss.global_avg == 1.5


def test_meter_sync_sums_count_and_total_in_float64(monkeypatch):
    """Two ranks' (count, total) summed: the sum goes through ``all_sum``
    as one float64 pair (stand-in ranks: the sum doubles it)."""
    from edgeml_tpu_torch.parallel import meters

    seen = []

    def fake_sum(x):
        seen.append(x.dtype)
        return x * 2

    monkeypatch.setattr(meters, "world_size", lambda: 2)
    monkeypatch.setattr(meters, "all_sum", fake_sum)
    v = SmoothedValue()
    v.update(0.1, n=3)
    v.synchronize_between_processes()
    assert seen == [torch.float64]
    assert v.count == 6 and v.total == 2 * (0.1 * 3)


@pytest.mark.parametrize("layout,cards,want", [
    ("cpu", 1, "gloo"), (2, 1, "gloo"), (2, 2, "nccl"), (1, 1, "nccl"),
    (4, 0, "gloo")])
def test_backend_follows_the_layout(monkeypatch, layout, cards, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE",
                       "1" if layout == "cpu" else str(layout))
    backend, why = mesh.choose_backend("cpu" if layout == "cpu" else None)
    assert backend == want and why


def test_local_device(monkeypatch):
    assert mesh.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.local_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")  # ranks outnumber the cards
    assert mesh.local_device() == torch.device("cuda", 1)
    assert mesh.make_mesh() == [torch.device("cuda", 0),
                                torch.device("cuda", 1)]
    assert mesh.make_mesh("cpu") == [torch.device("cpu")]


def test_shard_along_needs_an_even_split(monkeypatch):
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    assert mesh.shard_along([0, 1, 2, 3]) == [2, 3]
    assert torch.equal(mesh.shard_along(torch.arange(6).reshape(3, 2),
                                        dim=1), torch.tensor([[1], [3], [5]]))
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_along([0, 1, 2])
