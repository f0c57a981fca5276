"""The port's streaming kernels (K5a–c) and Table II's ablation kernels
(K6a–b), through their plain versions on CPU tensors, against the JAX
package's Pallas kernels in interpret mode, as the paper tables call them.

Inputs are made with numpy and handed to both packages. Every comparison
is bit for bit: the copies move elements unchanged, and the kernels that
do arithmetic (K5c's ordered f32 sum, K6b's ``(c+c+c+c)*0.25``) do the
same f32 operations in the same order as their plain versions. The
kernels themselves run only on a card (``tests/test_torch_cuda.py``).

K6a and K6b are compared on the rows the reference writes: its grids
cover ``(h - 2) // bm`` and ``h // bm`` whole blocks and leave the rows
past them undefined, while the port writes them too; those rows are held
against the reference kernel run on the last block alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import table2_components as jt2
from repro.kernels import ref as jref
from repro.kernels import stream as jstream
from repro_torch.kernels import components as TC
from repro_torch.kernels import stream as TS

DT = {"int32": (jnp.int32, torch.int32),
      "float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dname, seed=0):
    """The same array for both packages: ints up to 2**22 (so K5c's f32
    sums round), floats of a few thousand."""
    rng = np.random.default_rng(seed)
    if dname == "int32":
        a = rng.integers(-2**22, 2**22, size=shape, dtype=np.int32)
        return jnp.asarray(a), torch.from_numpy(a)
    jdt, tdt = DT[dname]
    j = jnp.asarray(rng.standard_normal(shape, dtype=np.float32) * 3000, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _bits(a) -> np.ndarray:
    """Bit patterns to compare; bf16 widens to f32 exactly first."""
    if isinstance(a, torch.Tensor):
        a = a.numpy() if a.dtype == torch.int32 else a.float().numpy()
    else:
        a = np.asarray(a if a.dtype == jnp.int32 else a.astype(jnp.float32))
    return a.view(np.uint32)


def _same(got: torch.Tensor, want) -> None:
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dname", list(DT))
@pytest.mark.parametrize("h,w,bm,bn", [(128, 256, 16, 256), (128, 256, 32, 64),
                                       (128, 256, 64, 8), (128, 256, 128, 32),
                                       (96, 258, 32, 129)])
def test_stream_copy_matches_pallas(h, w, bm, bn, dname):
    jx, tx = _inputs((h, w), dname)
    got = TS.stream_copy(tx, bm=bm, bn=bn)
    assert got.dtype == tx.dtype and got.data_ptr() != tx.data_ptr()
    _same(got, jstream.stream_copy(jx, bm=bm, bn=bn, interpret=True))


@pytest.mark.parametrize("dname", ["int32", "bfloat16"])
@pytest.mark.parametrize("sync", [False, True])
def test_stream_copy_rowdma_matches_pallas(sync, dname):
    jx, tx = _inputs((128, 256), dname, seed=1)
    got = TS.stream_copy_rowdma(tx, bm=16, sync=sync)
    _same(got, jstream.stream_copy_rowdma(jx, bm=16, sync=sync,
                                          interpret=True))


@pytest.mark.parametrize("dname", list(DT))
@pytest.mark.parametrize("factor", [1, 3, 7, 32])
def test_stream_replicated_matches_pallas(factor, dname):
    jx, tx = _inputs((128, 256), dname, seed=factor)
    got = TS.stream_replicated(tx, bm=16, factor=factor)
    assert got.dtype == tx.dtype
    _same(got, jstream.stream_replicated(jx, bm=16, factor=factor,
                                         interpret=True))


@pytest.mark.parametrize("factor", [3, 7, 32])
def test_stream_replicated_near_the_product_oracle(factor):
    """The reference's oracle multiplies by ``factor``; the kernel's
    ordered sum rounds differently but stays within f32 rounding."""
    jx, tx = _inputs((128, 256), "float32", seed=factor)
    got = TS.stream_replicated(tx, bm=16, factor=factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.stream_replicated(jx, factor)), rtol=1e-6)


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,w,bm", [(130, 258, 32), (100, 130, 16)])
def test_dma_only_matches_pallas(h, w, bm, dname):
    ju, tu = _inputs((h, w), dname, seed=2)
    got = TC.dma_only(tu, bm=bm)
    assert tuple(got.shape) == (h - 2, w - 2)
    covered = (h - 2) // bm * bm
    want = jt2.dma_only(ju, bm=bm, interpret=True)
    _same(got[:covered], want[:covered])
    # the rows past the reference's grid: its kernel on the last window
    _same(got[-bm:], jt2.dma_only(ju[-(bm + 2):], bm=bm, interpret=True))
    assert torch.equal(got, tu[1:-1, 1:-1])


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,w,bm", [(128, 258, 32), (100, 130, 16)])
def test_compute_only_matches_pallas(h, w, bm, dname):
    ju, tu = _inputs((h, w), dname, seed=3)
    got = TC.compute_only(tu, bm=bm)
    assert got.shape == tu.shape and got.dtype == tu.dtype
    covered = h // bm * bm
    _same(got[:covered], jt2.compute_only(ju, bm=bm,
                                          interpret=True)[:covered])
    _same(got[-bm:], jt2.compute_only(ju[-bm:], bm=bm, interpret=True))


def test_reference_asserts_become_value_errors():
    x = torch.zeros((96, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="bm=40"):
        TS.stream_copy(x, bm=40, bn=64)
    with pytest.raises(ValueError, match="bn=48"):
        TS.stream_copy(x, bm=32, bn=48)
    with pytest.raises(ValueError, match="bm=64"):
        TS.stream_copy_rowdma(x, bm=64, sync=True)
    with pytest.raises(ValueError, match="bm=0"):
        TS.stream_replicated(x, bm=0, factor=2)
    with pytest.raises(ValueError, match="factor"):
        TS.stream_replicated(x, bm=32, factor=0)
    with pytest.raises(TypeError, match="int32, float32 or bfloat16"):
        TS.stream_copy(x.double(), bm=32, bn=64)
    with pytest.raises(TypeError):
        TC.compute_only(x, bm=32)
    with pytest.raises(ValueError, match=">= 3"):
        TC.dma_only(x[:2], bm=32)


def test_plain_versions_count_no_launches():
    TS.reset_launch_counts()
    TC.reset_launch_counts()
    x = torch.ones((32, 64), dtype=torch.float32)
    TS.stream_copy(x, bm=16, bn=32)
    TS.stream_copy_rowdma(x, bm=16, sync=False)
    TS.stream_replicated(x, bm=16, factor=2)
    TC.dma_only(x, bm=16)
    TC.compute_only(x, bm=16)
    assert sum(TS.LAUNCHES.values()) + sum(TC.LAUNCHES.values()) == 0


@pytest.mark.parametrize("h,w,bm,bn,sms,split", [
    (4096, 4096, 256, 4096, 132, 16),   # Table III at bn 4096: 16 tiles
    (4096, 4096, 256, 1024, 132, 4),
    (4096, 4096, 256, 512, 132, 2),
    (4096, 4096, 256, 256, 132, 1),     # 256 tiles about fill the card
    (4096, 4096, 256, 8, 132, 1),
    (64, 4096, 4, 4096, 132, 4),        # never more blocks than rows
    (256, 256, 256, 256, 132, 256),
])
def test_copy_split_gives_about_two_blocks_an_sm(h, w, bm, bn, sms, split):
    got = TS.copy_split(h, w, bm, bn, sms)
    assert got == split
    tiles = (h // bm) * (w // bn)
    assert 1 <= got <= bm
    assert tiles * got <= max(2 * sms, tiles)
    assert tiles * (got + 1) > 2 * sms or got == bm


@pytest.mark.parametrize("row_bytes,bm", [
    (16384, 64), (1024, 16), (160, 32), (200000, 2), (32, 1)])
def test_rowdma_plan_puts_every_row_in_flight(row_bytes, bm):
    """Without ``sync`` every row of a bm-row block is its own block with
    one slot, so all bm rows are in flight at once (as the TPU keeps
    them); Table III's 4096 x 4096 int32 at bm 64 is 4096 blocks."""
    assert tuple(TS.rowdma_plan(row_bytes, bm, False)) == (bm, 1)


@pytest.mark.parametrize("row_bytes,bm", [
    (16384, 64), (1024, 16), (160, 32), (200000, 2), (32, 1)])
def test_rowdma_plan_with_sync_keeps_one_row_in_flight(row_bytes, bm):
    """With ``sync`` each bm-row block of the TPU's grid is one block
    (its rows issued one at a time by the kernel), with a second slot,
    where two fit, for the next row while the last one's store reads its
    own."""
    split, ring = TS.rowdma_plan(row_bytes, bm, True)
    assert split == 1 and ring == min(2, TS.RING_BYTES // row_bytes)


@pytest.mark.parametrize("n,passes", [(4, 1), (4096, 3), (12, 64)])
def test_l2_probe_plain_is_the_wrapped_word_sum(n, passes):
    """The L2 probe's value on the CPU: ``passes`` x the buffer's int32
    words summed mod 2**32 (what the card's kernel must store), and the
    inputs it refuses."""
    a = np.random.default_rng(n).integers(-2**31, 2**31 - 1, size=n,
                                          dtype=np.int32)
    want = int(a.astype(np.uint32).astype(np.uint64).sum()) * passes % 2**32
    got = TS.l2_read_probe(torch.from_numpy(a), passes=passes)
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got) % 2**32 == want
    with pytest.raises(ValueError):
        TS.l2_read_probe(torch.from_numpy(a).float(), passes=passes)
    with pytest.raises(ValueError):
        TS.l2_read_probe(torch.from_numpy(a[:-1]), passes=passes)
    with pytest.raises(ValueError):
        TS.l2_read_probe(torch.from_numpy(a), passes=0)
    with pytest.raises(ValueError):
        TS.l2_read_probe(torch.from_numpy(a), passes=passes, unroll=6)
