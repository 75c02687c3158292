"""The reference frames, the walk of a frame and the corrupted probes."""

import json

import numpy as np
import pytest

import lz4tpu_torch
from lz4bench import catalog, liblz4, reference
from lz4bench.corpora import silesia as corpus

CONFIGS = {n: json.loads((catalog.HERE / "configs" / f"{n}.json").read_text())
           for n in ("lz4f-64k-indep", "lz4f-4m-indep")}


@pytest.fixture(scope="module")
def objects():
    return corpus.members(23, scale=0.0006)


def test_write_reference_is_the_cli_frame_where_every_block_is_large():
    """Blocks of 65,547 B or more: the frame API and the U32 parse agree."""
    data = corpus.generate(4, "samba", 9 << 20, "source", 0.1329)
    cfg = CONFIGS["lz4f-4m-indep"]
    assert reference.frame(data, cfg) == reference.stored(data, cfg)


def test_header_and_checksum_are_the_c_librarys():
    data = corpus.generate(6, "xml", 200_000, "structured", 0.1491)
    for cfg in CONFIGS.values():
        cli = reference.stored(data, cfg)
        assert cli.startswith(reference.header(cfg)) and len(reference.header(cfg)) == 7
        assert liblz4.xxh32(data).to_bytes(4, "little") == cli[-4:]
    assert liblz4.xxh32(b"") == 0x02CC5D05  # XXH32 of no bytes, seed 0


def test_write_reference_of_no_bytes():
    for cfg in CONFIGS.values():
        assert reference.frame(b"", cfg) == reference.stored(b"", cfg)


def test_write_reference_at_64k_is_the_u32_parse_not_the_cli():
    data = corpus.generate(4, "dickens", 300_000, "text", 0.175)
    cfg = CONFIGS["lz4f-64k-indep"]
    assert reference.frame(data, cfg) != reference.stored(data, cfg)


@pytest.mark.parametrize("config", CONFIGS)
def test_program_plain_versions_meet_the_write_reference(objects, config):
    cfg = CONFIGS[config]
    for data in objects.values():
        frame = lz4tpu_torch.compress_frame_parallel(
            data, cfg["block_size"], device="cpu", content_checksum=True,
            block_checksums=False, with_content_size=False)
        assert frame == reference.frame(data, cfg)


@pytest.mark.parametrize("config", CONFIGS)
def test_blocks_walk_the_frame(objects, config):
    cfg = CONFIGS[config]
    data = b"".join(objects.values())
    frame = reference.stored(data, cfg)
    walked = reference.blocks(frame)
    assert len(walked) == -(-len(data) // cfg["block_size"])
    assert walked[-1][0] + walked[-1][1] + 8 == len(frame)  # end mark, checksum
    with pytest.raises(ValueError):
        reference.blocks(frame + b"\0")


@pytest.mark.parametrize("config", CONFIGS)
def test_corrupt_leaves_the_length_and_changes_the_content(objects, config):
    cfg = CONFIGS[config]
    rng = np.random.default_rng(5)
    for data in list(objects.values()) + [bytes(np.random.default_rng(1).integers(0, 256, 9000,
                                                                           np.uint8))]:
        frame = reference.stored(data, cfg)
        bad = reference.corrupt(frame, rng)
        assert sum(a != b for a, b in zip(frame, bad)) == 1 and len(bad) == len(frame)
        out = lz4tpu_torch.decompress_frame_parallel(bad, device="cpu", verify_checksums=False)
        assert len(out) == len(data) and out != data
        with pytest.raises(lz4tpu_torch.LZ4Error):
            lz4tpu_torch.decompress_frame_parallel(bad, device="cpu")
