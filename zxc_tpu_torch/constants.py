"""Wire-format constants for the ZXC v7 bitstream.

These values are fixed by the format specification (reference:
docs/FORMAT.md; numeric values cross-checked against
src/lib/zxc_internal.h and include/zxc_constants.h in the reference
implementation). They are part of the on-disk contract and must never
change without a format version bump.

The PyTorch port keeps its own copy of ``zxc_tpu.constants`` so that it
imports nothing of the JAX package; the two must stay identical.
"""

# --- File container (FORMAT.md section 3, 8, 13) ---
MAGIC_WORD = 0x9CB02EF5
FORMAT_VERSION = 7
FILE_HEADER_SIZE = 16
FILE_FOOTER_SIZE = 12
BLOCK_HEADER_SIZE = 8
BLOCK_CHECKSUM_SIZE = 4
SEEK_ENTRY_SIZE = 4

# Flags byte (header offset 0x06)
FLAG_HAS_CHECKSUM = 0x80
FLAG_HAS_DICTIONARY = 0x40
CHECKSUM_RAPIDHASH = 0  # bits 0..3: checksum algorithm id

# Block sizes: power-of-two exponents 12..21 (4 KiB .. 2 MiB)
BLOCK_SIZE_MIN_LOG2 = 12
BLOCK_SIZE_MAX_LOG2 = 21
BLOCK_SIZE_MIN = 1 << BLOCK_SIZE_MIN_LOG2
BLOCK_SIZE_MAX = 1 << BLOCK_SIZE_MAX_LOG2
BLOCK_SIZE_DEFAULT = 512 * 1024

# --- Block types (FORMAT.md section 4.1) ---
BLOCK_RAW = 0
BLOCK_GLO = 1
BLOCK_GHI = 2
BLOCK_SEK = 254
BLOCK_EOF = 255

# --- GLO / GHI payloads (FORMAT.md section 5) ---
GNR_HEADER_SIZE = 16       # shared GLO/GHI sub-header
SECTION_DESC_SIZE = 8      # packed u64: comp32 | raw32 << 32
GLO_SECTIONS = 4           # literals, tokens, offsets, extras
GHI_SECTIONS = 3           # literals, sequences, extras

# Section encodings (enc_lit / enc_litlen)
ENC_RAW = 0
ENC_RLE = 1
ENC_HUFFMAN = 2
ENC_HUFFMAN_DICT = 3

# GLO token byte: (LL << 4) | ML, 4-bit fields, 15 = saturated -> varint
TOKEN_LIT_BITS = 4
TOKEN_LL_MASK = 15
TOKEN_ML_MASK = 15

# GHI sequence word: LL(8) | ML(8) | off16, 255 = saturated -> varint
SEQ_LL_MASK = 255
SEQ_ML_MASK = 255

# LZ parameters fixed by the format
MIN_MATCH = 5              # decoded match length = ML field + 5
OFFSET_BIAS = 1            # stored offset = actual - 1
WINDOW_SIZE = 64 * 1024    # 16-bit biased offsets -> 64 KiB window

# RLE literal section tokens
LIT_RLE_FLAG = 0x80        # high bit set -> run token
LIT_LEN_MASK = 0x7F        # raw: len = (tok & 0x7F) + 1; run: (tok & 0x7F) + 4
RLE_RAW_MAX = 128          # max bytes in one raw copy token
RLE_RUN_MIN = 4
RLE_RUN_MAX = 0x7F + 4     # 131

# --- Huffman / PivCo (FORMAT.md section 5.2.1) ---
HUF_NUM_SYMBOLS = 256
HUF_TABLE_SIZE = 128       # 256 x 4-bit packed code lengths
HUF_MAX_CODE_LEN = 8       # levels <= 6
HUF_MAX_CODE_LEN_ULTRA = 11  # level 7
PIVCO_MAX_NODES = 2 * HUF_NUM_SYMBOLS - 1

# --- Dictionary (.zxd, FORMAT.md section 12.4) ---
DICT_MAGIC = 0x9CB0D1C7
DICT_FORMAT_VERSION = 1
DICT_HEADER_SIZE = 16
DICT_SIZE_MAX = (1 << 16) - 1

# --- Levels ---
LEVEL_MIN = 1
LEVEL_MAX = 7
LEVEL_DEFAULT = 3

# Header-hash primes (Marsaglia xorshift constants used by zxc_hash8/16)
HASH_PRIME1 = 0x9E3779B97F4A7C15
HASH_PRIME2 = 0xD2D84A61D2D84A61

# Varint (FORMAT.md section 6): 1..3 bytes, first byte >= 0xE0 is corrupt
VARINT_MAX_VALUE = (1 << 21) - 1


def block_size_code(block_size: int) -> int:
    """Exponent code for the file header (12..21)."""
    code = block_size.bit_length() - 1
    if (1 << code) != block_size or not (BLOCK_SIZE_MIN_LOG2 <= code <= BLOCK_SIZE_MAX_LOG2):
        raise ValueError(f"invalid block size {block_size}")
    return code


def compress_block_bound(block_size: int) -> int:
    """Worst-case compressed size of one block (header + RAW payload + checksum)."""
    return BLOCK_HEADER_SIZE + block_size + BLOCK_CHECKSUM_SIZE


def compress_bound(src_size: int, block_size: int = BLOCK_SIZE_DEFAULT) -> int:
    """Worst-case frame size: header + N raw blocks + EOF + seek table + footer."""
    n_blocks = (src_size + block_size - 1) // block_size if src_size else 0
    per_block = BLOCK_HEADER_SIZE + BLOCK_CHECKSUM_SIZE
    seek = BLOCK_HEADER_SIZE + n_blocks * SEEK_ENTRY_SIZE
    return (FILE_HEADER_SIZE + src_size + n_blocks * per_block
            + BLOCK_HEADER_SIZE + seek + FILE_FOOTER_SIZE + 64)
