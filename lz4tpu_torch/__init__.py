"""lz4tpu_torch — the PyTorch/CUDA port of lz4tpu for an NVIDIA H100.

A second package beside the JAX one: the same LZ4 block codec and frame
format, with the TPU's Pallas kernels replaced by CUDA kernels written by
hand for Hopper (``csrc/``, built by ``nvcc`` at first use, see
``build.py``) and the JAX glue by PyTorch tensors.  It imports neither
``jax`` nor anything of ``lz4tpu``.

Every entry point takes ``device=None``, meaning ``"cuda"``; without a card
that raises.  ``device="cpu"`` runs each kernel's plain version instead.
The streaming API has a third engine, ``"native"``: the host's C++ block
codec, HC parse and xxHash32 (``lz4tpu_torch.native``, built by ``c++``
into ``_build/`` at first use), which needs no card.

* frames, whole-frame on the device: ``compress_frame_parallel``
  (independent or ``parallel_linked``; ``lane_kernel=True`` for the lane
  compressor, which cuts big blocks into 32 KiB chunks and splices them),
  ``decompress_frame_parallel``, and ``decompress_frames_parallel`` (many
  frames, linked ones in waves); each takes ``mesh=`` in place of
  ``device=`` to spread a frame's blocks over this process's cards;
* the mesh and the resumable runner: ``make_mesh`` (every card, or
  ``devices=[...]``, a device named more than once allowed), ``local_mesh``,
  ``initialize_distributed`` (the rendezvous of a multi-process run on
  ``torch.distributed``), ``run_sharded_compress`` and
  ``run_sharded_decompress`` (a file to a multi-frame archive and back,
  shards claimed by process, resumable);
* frames, streaming (the reference crate's API): ``CompressionSettings``
  (engines ``"cuda"``, ``"cpu"`` and ``"native"``: an independent-block
  frame's blocks in one launch a batch on a device, on ``threads(n)``
  threads on ``"native"``; ``level()`` adds the HC parse on the host, the
  native engine's but on ``"cpu"``), ``LZ4FrameReader`` (``read_all`` of
  an independent frame in one launch, or on a thread pool on
  ``"native"``), ``LZ4FrameIoReader`` (``into_read``),
  ``decompress_frame``;
* the crate root's block codec: ``compress_block`` and
  ``decompress_block`` (the reference's signatures, ``device=None``
  meaning ``"cuda"``), ``compress_block_hc`` (host parse), ``XXHash32``
  and ``xxh32``;
* the command line: ``python3 -m lz4tpu_torch.cli.dolz4`` and
  ``python3 -m lz4tpu_torch.cli.delz4``; the C library as an oracle:
  ``lz4tpu_torch.interop``;
* raw blocks: ``compress_blocks``, ``compress_block_cuda``,
  ``compress_blocks_128`` (lane compressor: default, window and strict
  modes), ``splice_streams``,
  ``decompress_blocks``, ``decompress_block_cuda``,
  ``decompress_blocks_128``, ``decompress_blocks_v4``,
  ``decompress_blocks_big``, ``decompress_blocks_v3``;
* encoder-table state shared with the JAX package: ``tables_from_jax``,
  ``tables_to_numpy``, ``lane_tables_from_jax``, ``lane_tables_to_jax``.
"""

from .frame.compress import CompressionSettings
from .frame.decompress import LZ4FrameIoReader, LZ4FrameReader, decompress_frame
from .frame.errors import (
    CompressionError,
    DecompressionError,
    HeaderParseError,
    LZ4Error,
)
from .frame.header import MAGIC, WINDOW_SIZE
from .kernels.compress import compress_block_cuda, compress_blocks
from .kernels.compress import compress_block_cuda as compress_block
from .kernels.compress128 import compress_blocks_128
from .kernels.decode128 import decompress_blocks_128
from .kernels.decodebig import decompress_blocks_big
from .kernels.decompress import decompress_block_cuda, decompress_blocks
from .kernels.decompress import decompress_block_cuda as decompress_block
from .kernels.decompress_v3 import decompress_blocks_v3
from .kernels.decompress_v4 import decompress_blocks_v4
from .kernels.splice import splice_streams
from .parallel.mesh import initialize_distributed, local_mesh, make_mesh
from .parallel.pipeline import (
    compress_frame_parallel,
    decompress_frame_parallel,
    decompress_frames_parallel,
)
from .parallel.runner import run_sharded_compress, run_sharded_decompress
from .spec.block import BlockTooBig, DecodeError, Incompressible
from .spec.hc import compress_block_hc
from .spec.xxhash32 import XXHash32, xxh32
from .state import lane_tables_from_jax, lane_tables_to_jax, tables_from_jax, tables_to_numpy

__all__ = [
    "CompressionSettings",
    "LZ4FrameReader",
    "LZ4FrameIoReader",
    "decompress_frame",
    "compress_block",
    "compress_block_hc",
    "decompress_block",
    "XXHash32",
    "xxh32",
    "compress_frame_parallel",
    "decompress_frame_parallel",
    "decompress_frames_parallel",
    "make_mesh",
    "local_mesh",
    "initialize_distributed",
    "run_sharded_compress",
    "run_sharded_decompress",
    "compress_blocks",
    "compress_block_cuda",
    "compress_blocks_128",
    "splice_streams",
    "decompress_blocks",
    "decompress_block_cuda",
    "decompress_blocks_128",
    "decompress_blocks_v4",
    "decompress_blocks_big",
    "decompress_blocks_v3",
    "tables_from_jax",
    "tables_to_numpy",
    "lane_tables_from_jax",
    "lane_tables_to_jax",
    "DecodeError",
    "Incompressible",
    "BlockTooBig",
    "LZ4Error",
    "CompressionError",
    "DecompressionError",
    "HeaderParseError",
    "MAGIC",
    "WINDOW_SIZE",
]
