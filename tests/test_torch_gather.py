"""The plain versions of the row-gather kernels P1 and P2 against numpy
indexing, and the probe's inputs against the JAX script's draws."""
import numpy as np
import pytest
import torch

from envgs_tpu_torch.ops import gather as tgather
from envgs_tpu_torch.probes import dmagather


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["gather_rows", "gather_rows_win8"])
def test_gather_matches_numpy(fn, dtype):
    """out[j] = table[idx[j]] exactly (bytes moved, nothing computed), with
    repeated indices and both ends of the table."""
    rng = np.random.default_rng(1)
    S, n = 64, 300
    table = torch.tensor(rng.standard_normal((S, 128)).astype(np.float32)
                         ).to(dtype)
    idx = rng.integers(0, S, n).astype(np.int32)
    idx[:2] = (0, S - 1)
    got = getattr(tgather, fn)(table, torch.tensor(idx))
    assert got.dtype == dtype and got.shape == (n, 128)
    want = table.view(torch.int16 if dtype == torch.bfloat16
                      else torch.int32).numpy()[idx]
    np.testing.assert_array_equal(got.view(torch.int16 if dtype ==
                                           torch.bfloat16 else torch.int32
                                           ).numpy(), want)


def test_probe_inputs_are_the_scripts_draws():
    """probe_inputs draws the indices first, then the table, from
    default_rng(0), as scripts/tpu_micro_dmagather.py does; the probe
    itself refuses to run without a card."""
    S, cap = 40, 96
    tbf16, t32, idx = dmagather.probe_inputs("cpu", S, cap)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(idx.numpy(), rng.integers(0, S, cap))
    np.testing.assert_array_equal(
        t32.numpy(), rng.standard_normal((S, 128)).astype(np.float32))
    assert tbf16.dtype == torch.bfloat16 and idx.dtype == torch.int32
    assert dmagather.S == 500_000 and dmagather.CAP == 2 ** 21
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dmagather.main()
