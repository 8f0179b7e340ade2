"""The port's row gather (`scenedino_torch.kernels.row_gather`, the P1/P2
kernel) against the repository's Pallas row-gather probes on the CPU.

P1 (`tools/probe_pallas_gather.py`: four kernel bodies gathering 256 rows
of a 512x128 fp32 table) and P2 (`tools/bench_pallas_gather.py`'s
`gather_kernel`, here cut to 4096 rows of a 256x128 bf16 table in blocks
of 1024) run through `pl.pallas_call(..., interpret=True)`, the same
inputs through the port's wrapper, which takes its plain version
(`table[idx]`) on CPU tensors. A gather moves bytes and computes nothing,
so every comparison is exact equality.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from scenedino_torch.kernels import row_gather
from scenedino_torch.kernels.row_gather import row_gather_plain
from scenedino_torch.tools import bench_gather, probe_gather

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_pallas_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


P1 = _tool("probe_pallas_gather")
P2 = _tool("bench_pallas_gather")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port(table: np.ndarray, idx: np.ndarray, dtype=torch.float32) -> np.ndarray:
    t = torch.from_numpy(table.astype(np.float32)).to(dtype)
    before = row_gather.launches
    out = row_gather(t, torch.from_numpy(idx))
    assert row_gather.launches == before  # CPU tensors take the plain version
    assert torch.equal(out, row_gather_plain(t, torch.from_numpy(idx)))
    return out.float().numpy()


@pytest.mark.parametrize("body", ["k_take", "k_take_along", "k_loop_rows", "k_dynamic_slice_loop"])
def test_row_gather_matches_each_p1_body(body):
    """P1's `run` call in interpret mode: 256 indices into the arange table."""
    tab = jnp.arange(P1.ROWS * P1.C, dtype=jnp.float32).reshape(P1.ROWS, P1.C)
    idx = np.random.RandomState(0).randint(0, P1.ROWS, P1.BLK).astype(np.int32)
    ref = pl.pallas_call(
        getattr(P1, body),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((P1.BLK, P1.C), tab.dtype),
        interpret=True,
    )(jnp.asarray(idx), tab)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(ref, np.asarray(tab)[idx])
    np.testing.assert_array_equal(_port(np.asarray(tab), idx), ref)


def test_row_gather_matches_p2_gather_kernel():
    """P2's `pallas_gather` (grid over index blocks, the whole table in
    every block) at a cut-down shape, bf16 on both sides."""
    rows, C, n, blk = 256, P2.C, 4096, 1024
    rng = np.random.default_rng(0)
    tab = jnp.asarray(rng.normal(size=(rows, C)).astype(np.float32)).astype(jnp.bfloat16)
    idx = rng.integers(0, rows, n).astype(np.int32)
    ref = pl.pallas_call(
        P2.gather_kernel,
        grid=(n // blk,),
        in_specs=[
            pl.BlockSpec((blk,), lambda i: (i,), memory_space=pltpu.VMEM),
            pl.BlockSpec((rows, C), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((blk, C), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, C), tab.dtype),
        interpret=True,
    )(jnp.asarray(idx), tab)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(ref, np.asarray(tab.astype(jnp.float32))[idx])
    np.testing.assert_array_equal(_port(np.asarray(tab.astype(jnp.float32)), idx, torch.bfloat16), ref)


@pytest.mark.parametrize("shape,dtype", [((10, 16), torch.float32), ((7, 24), torch.bfloat16),
                                         ((5, 256), torch.float32)])
def test_row_gather_plain_is_take(shape, dtype):
    """Rows of 64 B, 48 B and 1 KB; repeated and boundary indices."""
    table = torch.randn(*shape).to(dtype)
    idx = torch.tensor([0, shape[0] - 1, 3, 3, 1, shape[0] - 1], dtype=torch.int32)
    assert torch.equal(row_gather(table, idx), torch.stack([table[int(i)] for i in idx]))


def test_row_gather_refuses_what_it_does_not_take():
    table = torch.randn(8, 16)
    idx = torch.zeros(4, dtype=torch.int32)
    for bad_table, bad_idx in ((table[None], idx), (table, idx.long()), (table, idx[None])):
        with pytest.raises(ValueError):
            row_gather(bad_table, bad_idx)
    with pytest.raises(IndexError):  # the plain version raises on an index out of range
        row_gather(table, torch.tensor([8], dtype=torch.int32))


def test_p1_tool_gathers_exactly_on_the_cpu_when_asked(capsys):
    assert probe_gather.run("cpu")
    assert "row_gather: RUNS, correct=True" in capsys.readouterr().out
    assert probe_gather.main(["--device", "cpu"]) == 0


def test_tools_refuse_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tools rightly run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_gather.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_gather.main([])


def test_p2_tool_inputs_are_p2s_shapes():
    table, idx = bench_gather.inputs(0, "cpu")
    assert table.shape == (P2.ROWS, P2.C) and table.dtype == torch.bfloat16
    assert idx.shape == (P2.P,) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < P2.ROWS
