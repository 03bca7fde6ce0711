"""The port's process-group bring-up, collectives and DCP checkpoints in
two gloo processes, and the launcher's handling of a failing rank.

``tools/launch.py -n 2`` starts ``torch_dist_worker.py`` (scenario
``distributed``) once: each rank joins through the launcher's env
(``MXNET_TPU_COORD_ADDR``/``RANK``/``NPROCS``) and runs every collective
of ``parallel.collectives`` on known values, which the test checks
exactly (integers and small float sums are exact).  A second launch has
rank 1 leave before a collective: rank 0's call must raise (the group's
finite timeout, or the closed connection), and the launcher must report
the failed rank with exit code 1.
"""
import os
import subprocess
import sys

import numpy as onp
import pytest

import torch_dist_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    return W.launch(2, "distributed", tmp_path_factory.mktemp("dist"))


@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_join_through_the_launchers_env(outs, rank):
    assert list(outs[rank]["env"]) == [rank, 2, 1]


@pytest.mark.parametrize("rank", [0, 1])
def test_bucketed_all_reduce_sums_every_dtype(outs, rank):
    want = onp.concatenate([onp.full(5, 3.0), onp.full(6, 21.0),
                            onp.arange(4) * 3.0])
    assert onp.array_equal(outs[rank]["all_reduce"], want)
    # three buckets at 24 bytes: 20 B of float32, 24 B of float32, ints
    assert list(outs[rank]["stats"][:1]) == [3]
    assert outs[rank]["stats"][2] == 0          # CPU tensors: no staging


@pytest.mark.parametrize("rank", [0, 1])
def test_ring_shift_exchange_gather_and_broadcast(outs, rank):
    out = outs[rank]
    assert onp.array_equal(out["ring_shift"], onp.full(2, 1.0 - rank))
    assert list(out["exchange"]) == [1 - rank, 7]
    assert onp.array_equal(out["all_gather"], [[0, 0], [1, 1]])
    assert onp.array_equal(out["broadcast"], onp.zeros(3))


@pytest.mark.parametrize("rank", [0, 1])
def test_all_to_all_splits_and_concatenates(outs, rank):
    # rank r sends rows [2j, 2j+2) of its (4, 3) block to rank j and
    # concatenates the blocks it gets along dim 1, in rank order
    blocks = [onp.arange(12, dtype="float32").reshape(4, 3) + 100 * s
              for s in (0, 1)]
    want = onp.concatenate([b[2 * rank:2 * rank + 2] for b in blocks],
                           axis=1)
    assert onp.array_equal(outs[rank]["all_to_all"], want)


@pytest.mark.parametrize("rank", [0, 1])
def test_group_checkpoints_keep_the_newest(outs, rank):
    assert list(outs[rank]["dcp_steps"]) == [2, 3]
    assert onp.array_equal(outs[rank]["dcp_w"], onp.full(4, 3.0))


def test_a_dead_peer_fails_the_collective_and_the_launch(tmp_path):
    with pytest.raises(RuntimeError, match="dead_peer ranks failed"):
        W.launch(2, "dead_peer", tmp_path, timeout=120, dist_timeout=30)
    assert bool(onp.load(tmp_path / "dead_peer_r0.npz")["raised"])


def test_the_launcher_propagates_a_failing_rank():
    code = "import os, sys; sys.exit(int(os.environ['MXNET_TPU_RANK']))"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
         "3", sys.executable, "-c", code], capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 1
    assert "workers [1, 2] failed: [0, 1, 2]" in proc.stderr
