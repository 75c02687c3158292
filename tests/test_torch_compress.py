"""The port's greedy compressor (plain version of ``csrc/compress.cu``)
against the JAX package's scalar kernel (interpret mode) and its spec.

A byte codec has no tolerance: bytes, Incompressible and the post-parse
encoder tables must be equal.  The same tables go to both packages
through ``lz4tpu_torch.state``.
"""

import random

import numpy as np
import pytest
import torch

import lz4tpu_torch as lt
from lz4tpu.frame.compress import CompressionSettings
from lz4tpu.kernels.compress import compress_blocks as jax_compress_blocks
from lz4tpu.spec.block import Incompressible as SpecIncompressible
from lz4tpu.spec.block import compress_block as spec_compress_block
from lz4tpu.spec.table import U16Table, U32Table, prime_u32_table
from lz4tpu_torch.kernels.compress import compress_batch
from lz4tpu_torch.state import tables_from_jax, tables_to_numpy


def _spec(data, cursor, table, accel=1, cap=None):
    try:
        return bytes(spec_compress_block(data, cursor, table, acceleration=accel, cap=cap))
    except SpecIncompressible:
        return None


def test_plain_matches_jax_scalar_kernel_interpret(corpus_sample):
    rng = random.Random(7)
    datas = [corpus_sample(700, 3000), corpus_sample(701, 2500),
             bytes(rng.getrandbits(8) for _ in range(1500))]
    caps = [None, 100, 1500]
    t_jax = [U32Table() for _ in datas]
    t_port = [t.copy() for t in t_jax]
    want, _ = jax_compress_blocks(datas, tables=t_jax, caps=caps)
    got, _ = lt.compress_blocks(datas, tables=t_port, caps=caps, device="cpu")
    assert got == want
    assert want[1] is None and want[2] is None  # caps hit: Incompressible
    for a, b in zip(t_jax, t_port):
        assert np.array_equal(a.dict, b.dict)


@pytest.mark.parametrize("table", ["u16", "u32"])
@pytest.mark.parametrize("accel", [1, 2, 7, 64])
def test_plain_matches_spec(table, accel, corpus_sample):
    for seed, size in ((accel * 10 + 1, 9000), (accel * 10 + 2, 40000), (accel, 17)):
        data = corpus_sample(seed, size)
        make = U16Table if table == "u16" else U32Table
        t1, t2 = make(), make()
        want = _spec(data, 0, t1, accel)
        outs, _ = lt.compress_blocks([data], [0], [t2], acceleration=accel, device="cpu")
        assert outs[0] == want
        assert np.array_equal(t1.dict, t2.dict)


@pytest.mark.parametrize("table", ["u16", "u32"])
def test_cap_aborts_with_the_table_mutated_like_the_spec(table, corpus_sample):
    rng = random.Random(11)
    data = corpus_sample(80, 6000)[:3000] + bytes(rng.getrandbits(8) for _ in range(3000))
    make = U16Table if table == "u16" else U32Table
    for cap in (10, 1200, 3100, 5990, len(data)):
        t1, t2 = make(), make()
        want = _spec(data, 0, t1, cap=cap)
        outs, _ = lt.compress_blocks([data], [0], [t2], caps=[cap], device="cpu")
        assert outs[0] == want
        assert np.array_equal(t1.dict, t2.dict), cap


def test_dictionary_cursor_and_in_kernel_priming(corpus_sample):
    dic = corpus_sample(90, 30000)
    data = corpus_sample(91, 40000)
    spec_table = U32Table()
    prime_u32_table(spec_table, dic)
    host_primed = spec_table.copy()
    want = _spec(dic + data, len(dic), spec_table)
    # host-primed table, as the frame writer does
    outs, _ = lt.compress_blocks([dic + data], [len(dic)], [host_primed], device="cpu")
    assert outs[0] == want
    assert np.array_equal(host_primed.dict, spec_table.dict)
    # the kernel's prime flag primes the same positions itself
    fresh = U32Table()
    outs, _ = lt.compress_blocks([dic + data], [len(dic)], [fresh], prime_prefix=True,
                                 device="cpu")
    assert outs[0] == want
    assert np.array_equal(fresh.dict, spec_table.dict)


def test_tensor_batch_through_state_matches_spec_tables(corpus_sample):
    """Tables (with nonzero offsets, as a linked stream slides them) go to
    both packages through ``tables_from_jax``/``tables_to_numpy``."""
    datas, cursors, jtables = [], [], []
    for k in range(4):
        window = corpus_sample(120 + k, 20000)
        block = corpus_sample(130 + k, 15000)
        t = U32Table()
        spec_compress_block(window, 0, t)  # earlier parse fills the table
        t.slide(5000 * k)
        datas.append(window[5000 * k:] + block)
        cursors.append(len(window) - 5000 * k)
        jtables.append(t)
    tables, offsets = tables_from_jax(jtables)
    spec_out = [_spec(d, c, t) for d, c, t in zip(datas, cursors, jtables)]
    width = max(map(len, datas))
    arr = np.zeros((len(datas), width), np.uint8)
    for i, d in enumerate(datas):
        arr[i, : len(d)] = np.frombuffer(d, np.uint8)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32)

    n = len(datas)
    out, out_len, status, table_out = compress_batch(
        torch.from_numpy(arr), i32([len(d) for d in datas]), i32(cursors), i32([-1] * n),
        i32([1] * n), offsets, i32([0] * n), tables)
    for i in range(n):
        assert status[i] == 0
        assert out[i, : out_len[i]].numpy().tobytes() == spec_out[i]
    for (d, off), t in zip(tables_to_numpy(table_out, offsets), jtables):
        assert off == t.offset
        assert np.array_equal(d, t.dict)


def test_state_round_trip_accepts_pairs_and_both_table_kinds():
    rng = np.random.default_rng(3)
    u16 = [(rng.integers(0, 1 << 16, 8192).astype(np.uint16), 7) for _ in range(2)]
    u32 = [(rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32), 9)]
    for pairs in (u16, u32):
        t, off = tables_from_jax(pairs)
        back = tables_to_numpy(t, off)
        for (a, oa), (b, ob) in zip(pairs, back):
            assert oa == ob and a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        tables_from_jax(u16 + u32)


def test_single_block_adapter_contract(corpus_sample):
    data = corpus_sample(150, 5000)
    assert lt.compress_block_cuda(data, device="cpu") == _spec(data, 0, U16Table())
    out = bytearray(b"xy")
    lt.compress_block_cuda(data, out=out, device="cpu")
    assert bytes(out[2:]) == _spec(data, 0, U16Table())
    with pytest.raises(lt.Incompressible):
        lt.compress_block_cuda(bytes(range(256)), cap=10, device="cpu")
    with pytest.raises(lt.BlockTooBig):
        lt.compress_block_cuda(b"a" * 70000, table=U16Table(), device="cpu")


@pytest.mark.parametrize("independent", [True, False])
def test_streaming_writer_matches_jax_writer(independent, corpus_sample):
    """The port's serial writer on the plain compressor equals the JAX
    package's (spec engine), linked mode included — there the tables'
    state and offsets carry from block to block."""
    data = corpus_sample(160, 150_000)
    dic = corpus_sample(161, 20000)
    want = (CompressionSettings().engine("spec").block_size(1 << 16)
            .independent_blocks(independent).block_checksums(True)
            .dictionary(5, dic).compress_bytes(data))
    got = (lt.CompressionSettings().engine("cpu").block_size(1 << 16)
           .independent_blocks(independent).block_checksums(True)
           .dictionary(5, dic).compress_bytes(data))
    assert got == want
