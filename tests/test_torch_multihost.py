"""The port's multi-process helpers (parallel/multihost.py) and collectives
(parallel/collectives.py) on the CPU: the single-process semantics of
tests/test_sharding.py::test_multihost_helpers, the same helpers over 3
spawned gloo ranks (tests/torch_ranks.py), the default group from
torchrun's variables, and Runner.test split over 2 ranks against 1."""
import copy
import json
import os
import socket

import numpy as np

from envgs_tpu_torch import cli
from envgs_tpu_torch.engine import Config, merge_dotted
from envgs_tpu_torch.parallel import multihost as mh
from torch_ranks import (
    collectives_worker,
    init_from_env_worker,
    multihost_worker,
    run_ranks,
    runner_test_worker,
)
from torch_threads import on_one_thread


def test_multihost_helpers_on_one_process():
    """Without a process group: rank 0 of 1, a barrier that returns, the
    reference's frame sharding ims[:, rank::world], a host sum that is the
    vector itself in float64."""
    assert mh.process_index() == 0
    assert mh.process_count() == 1
    assert mh.is_main_process()
    mh.barrier()
    items = list(range(10))
    s0 = mh.shard_for_host(items, rank=0, world=3)
    s1 = mh.shard_for_host(items, rank=1, world=3)
    s2 = mh.shard_for_host(items, rank=2, world=3)
    assert s0 == [0, 3, 6, 9] and s1 == [1, 4, 7] and s2 == [2, 5, 8]
    assert sorted(s0 + s1 + s2) == items
    assert mh.shard_for_host(items) == items
    out = mh.allsum_hosts([1.5, np.float32(0.1)])
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, [1.5, np.float64(np.float32(0.1))])


def test_multihost_helpers_on_three_ranks(tmp_path):
    """Over 3 ranks: each its index, one main, the barrier passed, its
    stride of the items, and the same float64 sum everywhere (1e-9 terms
    kept: no float32 rounding)."""
    res = run_ranks(multihost_worker, 3, tmp_path)
    for r, got in enumerate(res):
        assert got["index"] == r and got["count"] == 3
        assert got["main"] == (r == 0)
        assert got["shard"] == list(range(10))[r::3]
        np.testing.assert_allclose(got["sum"], [6.0, 0.75, 6e-9], rtol=1e-12)
        np.testing.assert_array_equal(got["sum"], res[0]["sum"])


def test_collectives_on_three_ranks(tmp_path):
    """psum / pmean / pmax / pmin / all_gather (stacked and tiled) /
    ppermute over 3 ranks, x = [r + 1, -r] on rank r, and the gradients of
    the sum over ranks of (r + 1) * output: psum's and pmean's cotangents
    summed over the axis, pmax's to the rank holding the maximum, the
    gather's slice of the summed cotangent, ppermute's sent back from the
    receiver (rank r gets rank r + 1's weight, the last rank nothing)."""
    res = run_ranks(collectives_worker, 3, tmp_path)
    wsum = 1.0 + 2.0 + 3.0
    xs = np.float32([[1, 0], [2, -1], [3, -2]])
    for r, got in enumerate(res):
        o, g = got["out"], got["grads"]
        assert o["index"] == r
        np.testing.assert_array_equal(o["psum"], xs.sum(0))
        np.testing.assert_allclose(o["pmean"], xs.mean(0), rtol=1e-7)
        np.testing.assert_array_equal(o["pmax"], xs.max(0))
        np.testing.assert_array_equal(o["pmin"], xs.min(0))
        np.testing.assert_array_equal(o["all_gather"], xs)
        np.testing.assert_array_equal(o["tiled"], xs.reshape(-1))
        np.testing.assert_array_equal(
            o["ppermute"], xs[r - 1] if r > 0 else np.zeros(2))
        np.testing.assert_array_equal(g["psum"], [wsum, wsum])
        np.testing.assert_allclose(g["pmean"], [wsum / 3] * 2, rtol=1e-7)
        np.testing.assert_array_equal(
            g["pmax"], [wsum if r == 2 else 0.0, wsum if r == 0 else 0.0])
        np.testing.assert_array_equal(g["all_gather"], [wsum, wsum])
        np.testing.assert_array_equal(g["tiled"], [wsum, wsum])
        np.testing.assert_array_equal(
            g["ppermute"], [r + 2.0] * 2 if r < 2 else [0.0, 0.0])
        assert got["reduced"]["calls"] > 0 and got["reduced"]["bytes"] > 0


def test_init_from_env(tmp_path):
    """init_from_env starts the default group from RANK / WORLD_SIZE /
    LOCAL_RANK / MASTER_ADDR / MASTER_PORT with the backend it is given
    and puts the rank on the device it is given."""
    with socket.socket() as s:  # a free port of the loopback
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    res = run_ranks(init_from_env_worker, 2, tmp_path, port)
    for r, got in enumerate(res):
        assert got == dict(device="cpu", index=r, count=2, backend="gloo",
                           sum=got["sum"])
        np.testing.assert_array_equal(got["sum"], [2.0, 1.0])


def _runner_cfg():
    return merge_dotted(cli.smoke_config().to_dict(), [
        "dataset_cfg.H=32", "dataset_cfg.W=32", "dataset_cfg.n_views=6",
        "dataset_cfg.eval_every=2"])


def test_runner_test_split_over_two_ranks(tmp_path):
    """Runner.test on 2 ranks: each renders its stride of the 3 eval views
    (rank 0 views 0 and 2, rank 1 view 1); the merged PSNR / SSIM / time
    means over all 3 equal a 1-process test of the same views (PSNR and
    SSIM within 1e-6); rank 0 alone writes the recorder's events and the
    merged metrics.json, rank 1 its own under rank1/."""
    d = _runner_cfg()
    one = str(tmp_path / "one")
    with on_one_thread():  # the reference records nothing
        runner = cli.make_runner(Config.wrap(merge_dotted(
            dict(copy.deepcopy(d), out_root=one),
            ["runner_cfg.record=false"])), device="cpu")
        want = runner.test(save_images=False)
    two = str(tmp_path / "two")
    res = run_ranks(runner_test_worker, 2, tmp_path, d, two)
    assert res[0]["frames"] == ["00", "04"] and res[1]["frames"] == ["02"]
    assert [f["name"] for f in want["frames"]] == ["00", "02", "04"]
    got = res[0]["summary"]
    assert got["n_views_total"] == 3
    for k in ("psnr_mean", "ssim_mean"):
        np.testing.assert_allclose(got[k], want["summary"][k], rtol=1e-6,
                                   err_msg=k)
    assert res[1]["summary"]["psnr_mean"] == got["psnr_mean"]
    result = os.path.join(two, "result", "smoke")
    with open(os.path.join(result, "metrics.json")) as f:
        merged = json.load(f)["summary"]
    assert merged["n_views_total"] == 3
    assert merged["psnr_mean"] == got["psnr_mean"]
    with open(os.path.join(result, "rank1", "metrics.json")) as f:
        assert [r["name"] for r in json.load(f)["frames"]] == ["02"]
    record = os.path.join(two, "record", "smoke")
    assert len([n for n in os.listdir(record) if "tfevents" in n]) == 1
    assert sorted(os.listdir(os.path.join(two, "result"))) == ["smoke"]
