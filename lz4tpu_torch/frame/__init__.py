"""The LZ4 frame format: header, streaming writer and reader, typed errors."""

from .compress import CompressionSettings
from .decompress import LZ4FrameIoReader, LZ4FrameReader, decompress_frame
from .header import INCOMPRESSIBLE, MAGIC, WINDOW_SIZE, BlockDescriptor, Flags
