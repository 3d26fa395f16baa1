"""GLO / GHI / RAW block section parse: payload -> (ll, ml, off, literals),
the parse half of ``zxc_tpu.codec.block_decode`` for the port's device
decode (``ops.batch.plan_frame``), and ``decode_block``, the one-call
native block decode that ``codec.seekable`` uses on the host.

The literal section decodes natively (RLE: ``zxch_rle_decode``; PivCo:
``zxch_pivco_decode``), and so do the varint extras
(``zxch_varint_chain``). Error codes equal the JAX package's. With
``defer_entropy`` a PivCo literal section (enc_lit 2 or 3) stays as wire
bytes, a ``DeferredSection``, for the device entropy decode
(``ops.pivco_device``); the token section still decodes on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C
from ..errors import (ZxcError, ERROR_CORRUPT_DATA, ERROR_OVERFLOW,
                      ERROR_DICT_REQUIRED, ERROR_BAD_BLOCK_TYPE)
from ..format import headers
from .. import runtime
from . import huffman


def decode_rle_literals(stream: np.ndarray, required_size: int) -> np.ndarray:
    """Tokenized RLE (reference: zxc_decompress.c:757-816): raw-copy
    tokens (high bit clear, len = tok+1, bytes follow) and run tokens
    (high bit set, len = (tok&0x7F)+4, one fill byte)."""
    if required_size == 0:
        return np.zeros(0, np.uint8)
    if len(stream) == 0:
        raise ZxcError(ERROR_CORRUPT_DATA, "empty RLE stream")
    return runtime.rle_decode(stream, required_size)


def _resolve_extras(mask_a: np.ndarray, mask_b: np.ndarray,
                    extras: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Resolve interleaved per-sequence (a=LL, b=ML) varint extensions."""
    n_var = int(mask_a.sum()) + int(mask_b.sum())
    if n_var == 0:
        z = np.zeros(len(mask_a), np.int64)
        return z, z.copy()
    vals, ok = runtime.varint_chain(extras, n_var)
    if not ok:
        raise ZxcError(ERROR_CORRUPT_DATA, "extras varint chain")
    both = mask_a.astype(np.int64) + mask_b.astype(np.int64)
    before = np.cumsum(both) - both
    a = np.zeros(len(mask_a), np.int64)
    b = np.zeros(len(mask_a), np.int64)
    a[mask_a] = vals.astype(np.int64)[before[mask_a]]
    b[mask_b] = vals.astype(np.int64)[(before + mask_a)[mask_b]]
    return a, b


@dataclass
class DeferredSection:
    """A PivCo literal section kept as wire bytes for the device entropy
    decode (``ops.pivco_device``): the batch ships the node runs instead
    of the decoded symbols. ``payload`` excludes the 128-byte lengths
    header; the tree is built on the host either way."""
    payload: np.ndarray   # u8 node-run bytes
    n: int                # symbol count
    tree: object          # huffman.PivcoTree

    def __len__(self):    # size bookkeeping treats it like the array
        return self.n

    def decode(self) -> np.ndarray:
        return huffman.decode_payload(self.payload, self.n, self.tree)


def _decode_literal_section(enc_lit: int, stream: np.ndarray,
                            required_size: int, dst_capacity: int,
                            dict_tree, defer_entropy: bool = False):
    if enc_lit == C.ENC_RAW:
        return stream
    if required_size > dst_capacity:
        raise ZxcError(ERROR_CORRUPT_DATA, "literal section larger than block")
    if enc_lit == C.ENC_RLE:
        return decode_rle_literals(stream, required_size)
    if enc_lit == C.ENC_HUFFMAN:
        if required_size == 0:
            return np.zeros(0, np.uint8)
        if defer_entropy:
            if len(stream) < C.HUF_TABLE_SIZE:
                raise ZxcError(ERROR_CORRUPT_DATA,
                               "section smaller than lengths header")
            tree = huffman.build_tree_packed(
                bytes(stream[:C.HUF_TABLE_SIZE]))
            return DeferredSection(stream[C.HUF_TABLE_SIZE:],
                                   required_size, tree)
        return huffman.decode_section(stream, required_size)
    if enc_lit == C.ENC_HUFFMAN_DICT:
        if dict_tree is None:
            raise ZxcError(ERROR_DICT_REQUIRED,
                           "enc_lit=3 without dictionary table")
        if required_size == 0:
            return np.zeros(0, np.uint8)
        if defer_entropy:
            return DeferredSection(stream, required_size, dict_tree)
        return huffman.decode_payload(stream, required_size, dict_tree)
    raise ZxcError(ERROR_CORRUPT_DATA, f"bad enc_lit {enc_lit}")


def parse_block_glo(payload: np.ndarray, dst_capacity: int, dict_tree=None,
                    defer_entropy: bool = False):
    """GLO payload -> (ll, ml, off, literals): int64 sequences (ml includes
    MIN_MATCH, off unbiased) and the uint8 literal stream (with
    ``defer_entropy``, a ``DeferredSection`` for a PivCo one)."""
    nd = C.GNR_HEADER_SIZE + C.GLO_SECTIONS * C.SECTION_DESC_SIZE
    gh, descs = headers.read_gnr_header(payload[:nd].tobytes(),
                                        C.GLO_SECTIONS)
    p = nd
    sz_lit, raw_lit = descs[0]
    sz_tok, _ = descs[1]
    sz_off, _ = descs[2]
    sz_ext, _ = descs[3]
    if p + sz_lit + sz_tok + sz_off + sz_ext != len(payload):
        raise ZxcError(ERROR_CORRUPT_DATA, "GLO sections do not tile payload")
    lit_stream = payload[p:p + sz_lit]
    p += sz_lit
    tok_stream = payload[p:p + sz_tok]
    p += sz_tok
    off_stream = payload[p:p + sz_off]
    p += sz_off
    extras = payload[p:p + sz_ext]

    literals = _decode_literal_section(gh.enc_lit, lit_stream, raw_lit,
                                       dst_capacity, dict_tree,
                                       defer_entropy)
    n_seq = gh.n_sequences
    if sz_off < (n_seq if gh.enc_off == 1 else 2 * n_seq):
        raise ZxcError(ERROR_CORRUPT_DATA, "offsets section too small")
    if gh.enc_litlen == C.ENC_HUFFMAN:
        tokens = (huffman.decode_section(tok_stream, n_seq) if n_seq
                  else np.zeros(0, np.uint8))
    elif gh.enc_litlen == C.ENC_RAW:
        if sz_tok < n_seq:
            raise ZxcError(ERROR_CORRUPT_DATA, "token section too small")
        tokens = tok_stream[:n_seq]
    else:
        raise ZxcError(ERROR_CORRUPT_DATA, f"bad enc_litlen {gh.enc_litlen}")

    ll = (tokens >> C.TOKEN_LIT_BITS).astype(np.int64)
    mlf = (tokens & C.TOKEN_ML_MASK).astype(np.int64)
    if gh.enc_off == 1:
        off = off_stream[:n_seq].astype(np.int64) + C.OFFSET_BIAS
    else:
        off = (off_stream[:2 * n_seq].view("<u2").astype(np.int64)
               + C.OFFSET_BIAS)
    ext_ll, ext_ml = _resolve_extras(ll == C.TOKEN_LL_MASK,
                                     mlf == C.TOKEN_ML_MASK, extras)
    return ll + ext_ll, mlf + ext_ml + C.MIN_MATCH, off, literals


def parse_block_ghi(payload: np.ndarray, dst_capacity: int):
    """GHI payload -> (ll, ml, off, literals)."""
    nd = C.GNR_HEADER_SIZE + C.GHI_SECTIONS * C.SECTION_DESC_SIZE
    gh, descs = headers.read_gnr_header(payload[:nd].tobytes(),
                                        C.GHI_SECTIONS)
    p = nd
    sz_lit, _ = descs[0]
    sz_seq, _ = descs[1]
    sz_ext, _ = descs[2]
    if p + sz_lit + sz_seq + sz_ext != len(payload):
        raise ZxcError(ERROR_CORRUPT_DATA, "GHI sections do not tile payload")
    literals = payload[p:p + sz_lit]
    p += sz_lit
    seq_stream = payload[p:p + sz_seq]
    p += sz_seq
    extras = payload[p:p + sz_ext]

    n_seq = gh.n_sequences
    if sz_seq < 4 * n_seq:
        raise ZxcError(ERROR_CORRUPT_DATA, "sequence section too small")
    words = seq_stream[:4 * n_seq].view("<u4").astype(np.int64)
    ll = words >> 24
    mlf = (words >> 16) & 0xFF
    off = (words & 0xFFFF) + C.OFFSET_BIAS
    ext_ll, ext_ml = _resolve_extras(ll == C.SEQ_LL_MASK,
                                     mlf == C.SEQ_ML_MASK, extras)
    return ll + ext_ll, mlf + ext_ml + C.MIN_MATCH, off, literals


def parse_block(block_type: int, payload: np.ndarray, dst_capacity: int,
                dict_tree=None, defer_entropy: bool = False):
    """Uniform parse for any data block type; a RAW block is the
    degenerate all-literal case. ``defer_entropy``: a GLO block's PivCo
    literal section comes back as a ``DeferredSection``."""
    if block_type == C.BLOCK_RAW:
        if len(payload) > dst_capacity:
            raise ZxcError(ERROR_OVERFLOW, "RAW block exceeds capacity")
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy(), payload
    if block_type == C.BLOCK_GLO:
        return parse_block_glo(payload, dst_capacity, dict_tree,
                               defer_entropy)
    if block_type == C.BLOCK_GHI:
        return parse_block_ghi(payload, dst_capacity)
    raise ZxcError(ERROR_BAD_BLOCK_TYPE, f"type {block_type}")


def decode_block(block_type: int, payload: np.ndarray, dst_capacity: int,
                 dict_buf: np.ndarray | None = None, dict_tree=None
                 ) -> np.ndarray:
    """The native block decode (the JAX package's ``decode_block`` with
    its native library; the port has no numpy decode to fall back on).
    The caller checks the payload checksum."""
    return runtime.decode_block(
        block_type, payload, dst_capacity, dict_buf,
        None if dict_tree is None else dict_tree.code_len)
