"""Host-side bitstream layer: bit I/O, NAL/EBSP, CABAC, high-level syntax.

Reference analogs (vvenc): CommonLib/BitStream.{h,cpp}, EncoderLib/NALwrite.cpp,
EncoderLib/BinEncoder.cpp, CommonLib/Contexts.cpp, EncoderLib/VLCWriter.cpp.
"""

from .bitwriter import BitWriter, BitReader
from .nal import NalUnitType, make_nal_unit, split_annexb, strip_ebsp
