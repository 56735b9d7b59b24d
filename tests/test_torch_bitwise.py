"""The port's bitwise contracts on plans beyond the quickstart, on 4 gloo
ranks (a (2, 2) mesh): each plan under ``impl="torch"`` and
``impl="matmul"``, forward and backward,

* the lossless traditional engine and the lossless pipelined engine (2, 3
  and 4 slices) equal the fused engine bitwise
  (``src/repro/core/pfft.py``'s promise for pipelined slices);
* two-field ``forward_many``/``backward_many`` equal the per-field loop
  bitwise under every ``batch_fusion``, lossless and int8 (one int8 scale
  per (field, chunk) gives each field its own exchange's scales;
  tests/test_batched.py's promise).

The plans are the pruned (12, 12, 12) plans, the r2c plans with odd trailing
extents, a 4-D plan and the DCT/DST plans (tests/_torch_ranks.py
``BITWISE_PLANS``).  Each local transform's rounding must not depend on the
other axes' extents: a stacked block and a pipelined slice transform the
same rows as one field's block does.
"""

import json

import pytest

import _torch_ranks as R

_ENGINES = ("traditional",) + tuple(f"pipelined{c}" for c in R.BITWISE_CHUNKS)


@pytest.fixture(scope="module")
def flags(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bitwise")
    R.start(R.run_bitwise_rank, d)()
    return json.loads((d / "bitwise.json").read_text())


@pytest.mark.parametrize("impl", R.BITWISE_IMPLS)
@pytest.mark.parametrize("plan", list(R.BITWISE_PLANS))
def test_lossless_engines_equal_fused(flags, plan, impl):
    missed = [e for e in _ENGINES if not flags[f"{plan}:{impl}:engine:{e}"]]
    assert not missed, f"{plan} {impl}: not bitwise equal to fused: {missed}"


@pytest.mark.parametrize("comm", ("complex64", "int8"))
@pytest.mark.parametrize("impl", R.BITWISE_IMPLS)
@pytest.mark.parametrize("plan", list(R.BITWISE_PLANS))
def test_many_equals_per_field_loop(flags, plan, impl, comm):
    missed = [f for f in R.BATCH_FUSIONS if not flags[f"{plan}:{impl}:many:{comm}:{f}"]]
    assert not missed, f"{plan} {impl} {comm}: not bitwise equal to the loop: {missed}"


def test_trig_matmul_rows_independent_of_row_count():
    """A DCT/DST matmul gives each row the same bits whether it is
    transformed alone, with a few rows or in a long block, at any position."""
    import torch

    from repro_torch.kernels.fft import ops

    g = torch.Generator().manual_seed(0)
    b = ops.TRIG_ROWS
    for n in (12, 20, 384):
        # two full blocks and a padded third
        x = torch.randn(2 * b + 700, n, generator=g)
        for fn in (ops.dct_matmul, ops.dst_matmul):
            for trig_type in (2, 3):
                whole = fn(x, axis=-1, trig_type=trig_type)
                for lo, hi in ((0, 1), (3, 5), (1, 65), (100, 700), (699, 700),
                               (b - 5, b + 9), (b + 1, 2 * b + 700), (2 * b + 699, 2 * b + 700)):
                    part = fn(x[lo:hi], axis=-1, trig_type=trig_type)
                    assert torch.equal(part, whole[lo:hi]), (n, fn.__name__, trig_type, lo, hi)
                # the same rows as the leading axis of a 3-D block
                blk = x[:60].T.reshape(n, 6, 10)
                got = fn(blk, axis=0, trig_type=trig_type)
                assert torch.equal(got.reshape(n, 60).T, whole[:60])
