"""Image IO without OpenCV: Radiance .hdr, 8-bit PNG, the JPEG header,
and the training-time plot dumps.

The port of the JAX package's `data/hdrio.py`, which reads and writes
through cv2; the machine with the card has no OpenCV or PIL, so:

  * .hdr is a numpy codec (Greg Ward's RGBE: one shared 8-bit exponent per
    pixel, the same rounding as ``cv2.imread``/``imwrite`` through Bruce
    Walter's rgbe routines).  Reading accepts flat and new-style
    run-length-encoded scanlines; writing emits flat scanlines.
  * PNG is a zlib/struct codec for 8- and 16-bit gray, gray+alpha, RGB
    and RGBA images: reading undoes all five scanline filters, so a PNG
    that cv2 wrote reads back bit-equal to ``cv2.imread`` (in RGB order);
    writing uses filter 0.
  * JPEG is not decoded: the datasets read only a panorama's size from
    it (``jpeg_size``, the SOF marker) — a JPEG carries no alpha mask.

All functions use RGB channel order; `flip` handles the v-up texture
convention (OBJ uv v=0 = bottom row, image files store the top row first).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_MAGIC = b"#?RADIANCE"


def float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] float → [H, W, 4] uint8 RGBE (truncating, as rgbe.c)."""
    img = np.asarray(img, np.float32)
    v = img.max(axis=-1)
    mant, exp = np.frexp(v)
    nz = v >= 1e-32
    scale = np.where(nz, mant * 256.0 / np.where(nz, v, 1.0), 0.0)
    out = np.zeros(img.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.where(
        nz[..., None], img * scale[..., None], 0.0
    ).astype(np.uint8)
    out[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return out


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[H, W, 4] uint8 RGBE → [H, W, 3] float32."""
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(1.0, e - (128 + 8)), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * f[..., None]


def _read_scanline(buf: bytes, pos: int, width: int):
    """One scanline at buf[pos:] → ([W, 4] uint8, new pos)."""
    head = buf[pos:pos + 4]
    rle = (
        8 <= width <= 0x7FFF and len(head) == 4
        and head[0] == 2 and head[1] == 2 and not head[2] & 0x80
    )
    if not rle:
        line = np.frombuffer(buf, np.uint8, 4 * width, pos).reshape(width, 4)
        return line, pos + 4 * width
    if (head[2] << 8 | head[3]) != width:
        raise ValueError("RLE scanline width mismatch")
    pos += 4
    line = np.empty((4, width), np.uint8)
    for c in range(4):
        x = 0
        while x < width:
            n = buf[pos]
            pos += 1
            if n > 128:
                n -= 128
                line[c, x:x + n] = buf[pos]
                pos += 1
            else:
                line[c, x:x + n] = np.frombuffer(buf, np.uint8, n, pos)
                pos += n
            x += n
    return line.T, pos


def read_hdr(path: str, flip: bool = False) -> np.ndarray:
    """Read a Radiance .hdr image as float32 RGB [H, W, 3]."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_MAGIC) and not buf.startswith(b"#?RGBE"):
        raise ValueError(f"{path}: not a Radiance file")
    end = buf.find(b"\n\n")
    if end < 0:
        raise ValueError(f"{path}: truncated header")
    nl = buf.find(b"\n", end + 2)
    res = buf[end + 2:nl].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res!r}")
    h, w = int(res[1]), int(res[3])
    pos = nl + 1
    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        rgbe[y], pos = _read_scanline(buf, pos, w)
    img = rgbe_to_float(rgbe)
    if flip:
        img = img[::-1]
    return np.ascontiguousarray(img)


def write_hdr(path: str, img: np.ndarray, flip: bool = False) -> None:
    """Write float32 RGB [H, W, 3] (or [H, W, 1]/[H, W]) to a .hdr file."""
    img = np.asarray(img, np.float32)
    if flip:
        img = img[::-1]
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    h, w = img.shape[:2]
    header = (
        _MAGIC + b"\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(float_to_rgbe(img[:, :, :3]).tobytes())


# ---------------------------------------------------------------------------
# PNG (8- and 16-bit) and the JPEG header
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type → samples per pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters → [h, w*bpp] uint8 (bpp: bytes
    a pixel)."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:    # Up
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):  # Sub, Average, Paeth: left-to-right
            cur = line.tolist()
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + up[i]) >> 1
                else:
                    b = up[i]
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8- or 16-bit, non-interlaced PNG → uint8 or uint16 [H, W]
    (gray) or [H, W, C] (gray+alpha, RGB, RGBA) in the file's channel
    order."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_PNG_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if head is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = head
    if depth not in (8, 16) or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8/16-bit non-interlaced gray/RGB(A) PNGs are "
            f"read (depth {depth}, colour type {ctype}, interlace "
            f"{interlace})"
        )
    ch = _PNG_CHANNELS[ctype]
    nb = depth // 8
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch * nb)
    if nb == 2:  # big-endian samples
        img = img.view(">u2").astype(np.uint16)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W] / [H, W, 1|2|3|4] as a PNG (filter 0): uint8 and uint16
    values as they are (8- and 16-bit), floats in [0, 1] scaled to 0..255
    (truncating)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    depth = 8 * img.itemsize
    img = np.ascontiguousarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch).astype(">u%d" % img.itemsize)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rows.view(np.uint8)], axis=1
    ).tobytes()

    def chunk(kind, data):
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def jpeg_size(path: str):
    """(height, width) of a JPEG from its start-of-frame marker."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    pos = 2
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG marker at {pos}")
        marker = buf[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        n = struct.unpack(">H", buf[pos + 2:pos + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">HH", buf[pos + 5:pos + 9])
            return int(h), int(w)
        pos += 2 + n
    raise ValueError(f"{path}: no start-of-frame marker")


def read_image(path: str) -> np.ndarray:
    """Read an 8- or 16-bit PNG as float32 RGB(A) (or gray) in [0, 1]."""
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        raise ValueError(
            f"{path}: JPEG pixels are not decoded; use jpeg_size for its size"
        )
    img = read_png(path)
    return img.astype(np.float32) / float(np.iinfo(img.dtype).max)


def read_gray(path: str) -> np.ndarray:
    """Read a PNG's raw values as float32 [H, W]: the gray channel, or the
    blue one of a colour PNG (channel 0 of cv2's BGR order)."""
    img = read_png(path)
    if img.ndim == 3:
        img = img[:, :, 2] if img.shape[2] >= 3 else img[:, :, 0]
    return img.astype(np.float32)


def tonemap_to_ldr(img: np.ndarray) -> np.ndarray:
    """γ-2.2 tonemapping to [0, 1] (reference tools/hdr2ldr.py)."""
    return np.clip(np.power(np.clip(img, 0, None), 1.0 / 2.2), 0.0, 1.0)


def plot_irf(path: str, pred: np.ndarray, gt: np.ndarray) -> None:
    """Stacked pred/gt HDR grid (reference utils/plots.py:27-49)."""
    write_hdr(path, np.concatenate([np.asarray(pred), np.asarray(gt)], axis=0))


def plot_gbuffer(path: str, position: np.ndarray, normal: np.ndarray) -> None:
    """Position / normal dump, the normal mapped to [0, 1] (reference
    utils/plots.py:51-67)."""
    write_hdr(path, np.concatenate(
        [np.asarray(position), np.asarray(normal) * 0.5 + 0.5], axis=0))


def plot_mat(path: str, rgb: np.ndarray, gt: np.ndarray) -> None:
    """Render/GT grid (reference utils/plots.py:69-85): face stacks
    [F, H, W, C] tiled horizontally, the render above the GT."""

    def tile(x):
        x = np.asarray(x)
        return np.concatenate(list(x), axis=1) if x.ndim == 4 else x

    write_hdr(path, np.concatenate([tile(rgb), tile(gt)], axis=0))
