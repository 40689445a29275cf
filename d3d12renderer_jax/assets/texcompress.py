"""Host-side block texture compression for the derived-data cache.

The reference caches decoded textures as `.cache.dds` with BC-format
compression + generated mips (reference: src/asset/image.cpp:76-96,
DirectXTex-backed), paying ~0.5 byte/texel on disk instead of the decoded
size.  Decoding happens on the host here, and the cache keeps the
SAME cache economics with a host codec: LDR mips are stored as BC1 blocks
(0.5 B/texel, 24x smaller than the float32 RGB they decode to) and HDR
mips as float16 (2x), both decoded to float32 linear at load time.  The
encoder is a vectorized NumPy range-fit (bounding-box endpoints projected
to the BC1 4-level palette) — the same family as the reference's fast CPU
path; encode + decode round a 1k texture in milliseconds.

BC1 quantizes in sRGB space (like the reference's DDS path): linear input
is transfer-encoded before block fitting and decoded back on load, so the
perceptual error lands where sRGB hides it.
"""

from __future__ import annotations

import numpy as np


def _to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)


def _from_srgb(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4))


def _pack565(c: np.ndarray) -> np.ndarray:
    """(N,3) floats [0,1] -> (N,) uint32 RGB565."""
    r = np.clip(np.round(c[:, 0] * 31.0), 0, 31).astype(np.uint32)
    g = np.clip(np.round(c[:, 1] * 63.0), 0, 63).astype(np.uint32)
    b = np.clip(np.round(c[:, 2] * 31.0), 0, 31).astype(np.uint32)
    return (r << 11) | (g << 5) | b


def _unpack565(v: np.ndarray) -> np.ndarray:
    r = ((v >> 11) & 31).astype(np.float32) / 31.0
    g = ((v >> 5) & 63).astype(np.float32) / 63.0
    b = (v & 31).astype(np.float32) / 31.0
    return np.stack([r, g, b], axis=-1)


def _blocks(img: np.ndarray):
    """(H,W,3) -> padded (N,16,3) 4x4 blocks + original dims."""
    h, w = img.shape[:2]
    ph, pw = (-h) % 4, (-w) % 4
    img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    hb, wb = img.shape[0] // 4, img.shape[1] // 4
    blk = img.reshape(hb, 4, wb, 4, 3).transpose(0, 2, 1, 3, 4)
    return blk.reshape(-1, 16, 3), h, w, hb, wb


def bc1_encode(img: np.ndarray) -> dict:
    """(H,W,3) float32 LINEAR RGB -> BC1 block dict.

    Range-fit: bounding-box endpoints in sRGB space, texels projected onto
    the endpoint axis and snapped to the 4-level BC1 palette derived from
    the QUANTIZED (565) endpoints.  c0 > c1 is forced so decoders always
    take the 4-color mode."""
    srgb = _to_srgb(np.asarray(img, np.float32))
    blk, h, w, hb, wb = _blocks(srgb)

    lo = blk.min(axis=1)                          # (N,3)
    hi = blk.max(axis=1)
    # Inset by 1/16 of the range: stops extreme texels from wasting the
    # two middle palette entries (standard range-fit trick).
    inset = (hi - lo) / 16.0
    c1q = _pack565(lo + inset)                    # low endpoint
    c0q = _pack565(hi - inset)                    # high endpoint
    # Force 4-color mode: c0 must compare > c1 as uint16.
    swap = c0q < c1q
    c0q2 = np.where(swap, c1q, c0q)
    c1q = np.where(swap, c0q, c1q)
    c0q = c0q2
    degenerate = c0q == c1q

    e0 = _unpack565(c0q)                          # palette from QUANTIZED ends
    e1 = _unpack565(c1q)
    axis = e0 - e1                                # (N,3)
    den = np.maximum((axis * axis).sum(-1), 1e-12)
    # t in [0,1]: 1 -> e0, 0 -> e1.
    t = ((blk - e1[:, None, :]) * axis[:, None, :]).sum(-1) / den[:, None]
    # BC1 palette order: idx0=c0 (t=1), idx1=c1 (t=0), idx2=2/3c0+1/3c1,
    # idx3=1/3c0+2/3c1.  Snap t to {1, 0, 2/3, 1/3}.
    level = np.clip(np.round(t * 3.0), 0, 3).astype(np.int64)  # thirds
    idx = np.choose(level, [np.uint32(1), np.uint32(3),
                            np.uint32(2), np.uint32(0)]).astype(np.uint32)
    idx = np.where(degenerate[:, None], np.uint32(0), idx)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    packed_idx = (idx << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32)

    return {
        "format": "bc1",
        "h": int(h), "w": int(w),
        "ends": (c0q | (c1q << 16)).astype(np.uint32),  # (N,)
        "idx": packed_idx,                               # (N,)
    }


def bc1_decode(blocks: dict) -> np.ndarray:
    """BC1 block dict -> (H,W,3) float32 LINEAR RGB."""
    ends = blocks["ends"]
    c0 = _unpack565(ends & 0xFFFF)
    c1 = _unpack565(ends >> 16)
    pal = np.stack([c0, c1, (2.0 * c0 + c1) / 3.0, (c0 + 2.0 * c1) / 3.0],
                   axis=1)                            # (N,4,3)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    idx = (blocks["idx"][:, None] >> shifts) & 3      # (N,16)
    texels = np.take_along_axis(pal, idx[..., None].astype(np.int64),
                                axis=1)               # (N,16,3)
    h, w = blocks["h"], blocks["w"]
    hb, wb = (h + 3) // 4, (w + 3) // 4
    img = texels.reshape(hb, wb, 4, 4, 3).transpose(0, 2, 1, 3, 4)
    img = img.reshape(hb * 4, wb * 4, 3)[:h, :w]
    return _from_srgb(img).astype(np.float32)


def pack_mips(mips, hdr: bool) -> dict:
    """Mip list -> compact cache payload: BC1 for 8-bit-sourced LDR RGB,
    f16 for HDR, high-bit-depth, or non-RGB shapes.

    BC1 eligibility is decided from mip 0: the image must round-trip 8-bit
    sRGB within half an LSB — a 16-bit PNG (heightmaps, linear masks) fails
    that test and keeps full f16 precision."""
    use_bc1 = False
    if not hdr and mips:
        m0 = np.asarray(mips[0], np.float32)
        if m0.ndim == 3 and m0.shape[-1] == 3 and m0.min() >= 0.0 \
                and m0.max() <= 1.0:
            s = _to_srgb(m0)
            use_bc1 = bool(np.abs(np.round(s * 255.0) / 255.0 - s).max()
                           < 1.0 / 510.0)
    out = []
    for m in mips:
        m = np.asarray(m, np.float32)
        if (use_bc1 and m.ndim == 3 and m.shape[-1] == 3
                and min(m.shape[:2]) >= 4):
            out.append(bc1_encode(m))
        else:
            out.append({"format": "f16", "data": m.astype(np.float16)})
    return {"format": "texmips", "mips": out}


def unpack_mips(payload: dict):
    out = []
    for m in payload["mips"]:
        if m["format"] == "bc1":
            out.append(bc1_decode(m))
        else:
            out.append(np.asarray(m["data"], np.float32))
    return out
