"""Byte-exact Python reference renderers (the golden oracle).

Re-derivation of the reference's *scalar* renderers, which define the
production on-the-wire bytes (SURVEY.md A.1-A.2). Every device kernel + native
emitter pair in this framework is golden-tested against these functions.

Sources of truth (file:line in the reference C tree, zfogg/ascii-chat):
- mono:              image_print, lib/video/ascii/scalar/foreground.c:27-138
- truecolor FG RLE:  image_print_color, foreground.c:195-308
- truecolor no-RLE:  image_print_color_utf8, foreground.c:312-368
- 256-color:         image_print_256color, foreground.c:433-509
- 16-color:          image_print_16color, foreground.c:535-624
- 16-color dithered: image_print_16color_dithered(+_with_background),
                     foreground.c:650-846
- halfblocks:        lib/video/ascii/scalar/halfblock.c (truecolor :48, mono
                     :184, 16 :297, 256 :416)
- SGR/REP grammar:   lib/video/ascii/output_buffer.c:107-164
- quantizers:        lib/video/terminal/ansi.c:360-583
- entry point:       ascii_convert_with_capabilities, lib/video/ascii/ascii.c:194-387

These are intentionally straightforward per-pixel loops — clarity over speed;
the fast path is asciichat_tpu_torch.ops (device) + the native emitter.
"""

from __future__ import annotations

import numpy as np

from asciichat_tpu_torch.render import palette as pal
from asciichat_tpu_torch.render.types import ColorLevel, RenderMode, TerminalCapabilities
from asciichat_tpu_torch.utils.aspect import aspect_ratio, resize_indices

ESC = b"\x1b"
RESET = b"\x1b[0m"
HB = b"\xe2\x96\x80"  # U+2580 upper half block

# 16-color ANSI palette (ansi.c:442-459)
ANSI16_RGB = np.array(
    [
        (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0),
        (0, 0, 128), (128, 0, 128), (0, 128, 128), (192, 192, 192),
        (128, 128, 128), (255, 0, 0), (0, 255, 0), (255, 255, 0),
        (0, 0, 255), (255, 0, 255), (0, 255, 255), (255, 255, 255),
    ],
    dtype=np.int64,
)
_FG16_CODES = [str(c).encode() for c in list(range(30, 38)) + list(range(90, 98))]
_BG16_CODES = [str(c).encode() for c in list(range(40, 48)) + list(range(100, 108))]


def luminance(r: int, g: int, b: int) -> int:
    """ITU-R BT.601 integer luma with rounding (foreground.c:93)."""
    return (77 * r + 150 * g + 29 * b + 128) >> 8


def clamp_rgb(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def sgr_truecolor_fg(r: int, g: int, b: int) -> bytes:
    return b"\x1b[38;2;%d;%d;%dm" % (r, g, b)


def sgr_truecolor_bg(r: int, g: int, b: int) -> bytes:
    return b"\x1b[48;2;%d;%d;%dm" % (r, g, b)


def sgr_256_fg(idx: int) -> bytes:
    return b"\x1b[38;5;%dm" % idx


def sgr_256_bg(idx: int) -> bytes:
    return b"\x1b[48;5;%dm" % idx


def sgr_16_fg(idx: int) -> bytes:
    if idx >= 16:
        idx = 7
    return b"\x1b[" + _FG16_CODES[idx] + b"m"


def sgr_16_bg(idx: int) -> bytes:
    if idx >= 16:
        idx = 0
    return b"\x1b[" + _BG16_CODES[idx] + b"m"


def rep_is_profitable(runlen: int) -> bool:
    """output_buffer.c:148-154."""
    if runlen <= 2:
        return False
    k = runlen - 1
    return k > len(str(k)) + 3


def emit_rep(extra: int) -> bytes:
    return b"\x1b[%db" % extra


def rgb_to_256color(r: int, g: int, b: int) -> int:
    """ansi.c:360-379 (gray if sum |c-avg| < 30 else 6x6x6 cube)."""
    avg = (r + g + b) // 3
    gray_diff = abs(r - avg) + abs(g - avg) + abs(b - avg)
    if gray_diff < 30:
        return 232 + (avg * 23) // 255
    r6 = (r * 5) // 255
    g6 = (g * 5) // 255
    b6 = (b * 5) // 255
    return 16 + r6 * 36 + g6 * 6 + b6


def rgb_to_16color(r: int, g: int, b: int) -> int:
    """Nearest of 16 by squared distance, first-wins ties (ansi.c:437-477)."""
    d = (ANSI16_RGB[:, 0] - r) ** 2 + (ANSI16_RGB[:, 1] - g) ** 2 + (ANSI16_RGB[:, 2] - b) ** 2
    return int(np.argmin(d))


def _c_div16(v: int) -> int:
    """C integer division truncates toward zero: (v)/16 (ansi.c:551-577)."""
    return v // 16 if v >= 0 else -((-v) // 16)


# ---------------------------------------------------------------------------
# Foreground-mode renderers (each takes uint8 [H, W, 3], returns bytes)


def render_mono(rgb: np.ndarray, palette: str = pal.DEFAULT_PALETTE) -> bytes:
    """image_print (foreground.c:27-138): run key is char_index_ramp[luma>>2];
    glyph is cache64[key] (palette-index double indirection); REP-compressed;
    no SGR, '\\n' between rows only."""
    cache = pal.get_palette_cache(palette)
    glyphs = cache.mono_glyphs()
    ramp = cache.char_index_ramp
    h, w = rgb.shape[:2]
    px = rgb.astype(np.int64)
    luma = np.clip((77 * px[..., 0] + 150 * px[..., 1] + 29 * px[..., 2] + 128) >> 8, 0, 255)
    keys = np.take(np.asarray(ramp, dtype=np.int64), luma >> 2)
    out = bytearray()
    for y in range(h):
        row = keys[y]
        x = 0
        while x < w:
            k = int(row[x])
            j = x + 1
            while j < w and int(row[j]) == k:
                j += 1
            run = j - x
            g = glyphs[k]
            out += g
            if rep_is_profitable(run):
                out += emit_rep(run - 1)
            else:
                out += g * (run - 1)
            x = j
        if y != h - 1:
            out += b"\n"
    return bytes(out)


def render_truecolor_fg(rgb: np.ndarray, palette: str = pal.DEFAULT_PALETTE) -> bytes:
    """image_print_color (foreground.c:195-308): SGR only on color change via
    ansi_rle ctx (ansi.c:248-300); multi-byte glyphs bypass RLE (always emit
    SGR, do NOT update ctx state); one trailing reset for the whole frame."""
    cache = pal.get_palette_cache(palette)
    h, w = rgb.shape[:2]
    out = bytearray()
    first_pixel = True
    last = (255, 255, 255)  # ansi_rle_init (ansi.c:255-257)
    for y in range(h):
        for x in range(w):
            r, g, b = (int(v) for v in rgb[y, x])
            lum = clamp_rgb(luminance(r, g, b))
            glyph = cache.cache256[lum]
            if len(glyph) == 1 and glyph[0] < 128:
                # ASCII char: RLE path (ansi_rle_add_pixel, ansi.c:261-300)
                if first_pixel or (r, g, b) != last:
                    out += sgr_truecolor_fg(r, g, b)
                    last = (r, g, b)
                    first_pixel = False
                out += glyph
            else:
                # multi-byte UTF-8: direct write, ctx state untouched
                # (foreground.c:286-296)
                out += sgr_truecolor_fg(r, g, b)
                out += glyph
        if y != h - 1:
            out += b"\n"
    out += RESET  # ansi_rle_finish (ansi.c:303-311)
    return bytes(out)


def render_truecolor_fg_utf8(rgb: np.ndarray, palette: str = pal.DEFAULT_PALETTE) -> bytes:
    """image_print_color_utf8 (foreground.c:312-368): SGR before every pixel,
    reset at end of every row, no RLE (non-SIMD/WASM builds)."""
    cache = pal.get_palette_cache(palette)
    h, w = rgb.shape[:2]
    out = bytearray()
    for y in range(h):
        for x in range(w):
            r, g, b = (int(v) for v in rgb[y, x])
            out += sgr_truecolor_fg(r, g, b)
            out += cache.cache256[clamp_rgb(luminance(r, g, b))]
        out += RESET
        if y < h - 1:
            out += b"\n"
    return bytes(out)


def render_256color(rgb: np.ndarray, palette: str = pal.DEFAULT_PALETTE) -> bytes:
    """image_print_256color (foreground.c:433-509): SGR every pixel; glyph from
    the 256-entry luminance cache; reset after every row."""
    cache = pal.get_palette_cache(palette)
    h, w = rgb.shape[:2]
    out = bytearray()
    for y in range(h):
        for x in range(w):
            r, g, b = (int(v) for v in rgb[y, x])
            out += sgr_256_fg(rgb_to_256color(r, g, b))
            out += cache.cache256[clamp_rgb(luminance(r, g, b))]
        out += RESET
        if y < h - 1:
            out += b"\n"
    return bytes(out)


def render_16color(rgb: np.ndarray, palette: str = pal.DEFAULT_PALETTE) -> bytes:
    """image_print_16color (foreground.c:535-624): SGR every pixel; glyph from
    cache[char_idx] — the 256-entry cache indexed by the *palette index*
    (production quirk, foreground.c:597-599)."""
    cache = pal.get_palette_cache(palette)
    ramp = cache.char_index_ramp
    h, w = rgb.shape[:2]
    out = bytearray()
    for y in range(h):
        for x in range(w):
            r, g, b = (int(v) for v in rgb[y, x])
            out += sgr_16_fg(rgb_to_16color(r, g, b))
            lum = clamp_rgb(luminance(r, g, b))
            out += cache.cache256[ramp[lum >> 2]]
        out += RESET
        if y < h - 1:
            out += b"\n"
    return bytes(out)


def _fs_dither_indices(rgb: np.ndarray) -> np.ndarray:
    """Floyd-Steinberg 16-color index map (rgb_to_16color_dithered,
    ansi.c:511-583): raster order, integer errors, C truncating division."""
    h, w = rgb.shape[:2]
    err = np.zeros((h, w, 3), dtype=np.int64)
    out = np.zeros((h, w), dtype=np.int64)
    for y in range(h):
        for x in range(w):
            r = int(rgb[y, x, 0]) + int(err[y, x, 0])
            g = int(rgb[y, x, 1]) + int(err[y, x, 1])
            b = int(rgb[y, x, 2]) + int(err[y, x, 2])
            err[y, x] = 0
            idx = rgb_to_16color(clamp_rgb(r), clamp_rgb(g), clamp_rgb(b))
            out[y, x] = idx
            ar, ag, ab = (int(v) for v in ANSI16_RGB[idx])
            er, eg, eb = r - ar, g - ag, b - ab
            if x + 1 < w:
                err[y, x + 1, 0] += _c_div16(er * 7)
                err[y, x + 1, 1] += _c_div16(eg * 7)
                err[y, x + 1, 2] += _c_div16(eb * 7)
            if y + 1 < h:
                if x - 1 >= 0:
                    err[y + 1, x - 1, 0] += _c_div16(er * 3)
                    err[y + 1, x - 1, 1] += _c_div16(eg * 3)
                    err[y + 1, x - 1, 2] += _c_div16(eb * 3)
                err[y + 1, x, 0] += _c_div16(er * 5)
                err[y + 1, x, 1] += _c_div16(eg * 5)
                err[y + 1, x, 2] += _c_div16(eb * 5)
                if x + 1 < w:
                    err[y + 1, x + 1, 0] += _c_div16(er * 1)
                    err[y + 1, x + 1, 1] += _c_div16(eg * 1)
                    err[y + 1, x + 1, 2] += _c_div16(eb * 1)
    return out


def render_16color_dithered(rgb: np.ndarray, palette: str = pal.DEFAULT_PALETTE) -> bytes:
    """image_print_16color_dithered (foreground.c:650-749)."""
    cache = pal.get_palette_cache(palette)
    ramp = cache.char_index_ramp
    h, w = rgb.shape[:2]
    colors = _fs_dither_indices(rgb)
    out = bytearray()
    for y in range(h):
        for x in range(w):
            r, g, b = (int(v) for v in rgb[y, x])
            out += sgr_16_fg(int(colors[y, x]))
            lum = clamp_rgb(luminance(r, g, b))
            out += cache.cache256[ramp[lum >> 2]]
        out += RESET
        if y < h - 1:
            out += b"\n"
    return bytes(out)


def render_16color_dithered_bg(
    rgb: np.ndarray, use_background: bool = True, palette: str = pal.DEFAULT_PALETTE
) -> bytes:
    """image_print_16color_dithered_with_background (foreground.c:752-846).
    This is also the production TRUECOLOR+BACKGROUND renderer via the
    image_print_color_simd fallthrough (sgr.c:429-430)."""
    cache = pal.get_palette_cache(palette)
    h, w = rgb.shape[:2]
    colors = _fs_dither_indices(rgb)
    out = bytearray()
    for y in range(h):
        for x in range(w):
            r, g, b = (int(v) for v in rgb[y, x])
            idx = int(colors[y, x])
            if use_background:
                br, bg_, bb = (int(v) for v in ANSI16_RGB[idx])
                bg_lum = (br * 77 + bg_ * 150 + bb * 29) // 256  # no +128 (foreground.c:804)
                fg = 15 if bg_lum < 127 else 0
                out += sgr_16_bg(idx)
                out += sgr_16_fg(fg)
            else:
                out += sgr_16_fg(idx)
            lum = clamp_rgb(luminance(r, g, b))
            out += cache.cache256[lum]  # direct luminance glyph (foreground.c:820)
        out += RESET
        if y < h - 1:
            out += b"\n"
    return bytes(out)


# ---------------------------------------------------------------------------
# Half-block renderers (2 source rows -> 1 output line)


def _hb_rows(rgb: np.ndarray):
    """Yield (top_row, bot_row, is_last) with odd-height bottom duplication."""
    h = rgb.shape[0]
    for y in range(0, h, 2):
        top = rgb[y]
        bot = rgb[y + 1] if y + 1 < h else rgb[y]
        yield top, bot, (y + 2 >= h)


def render_halfblock_truecolor(rgb: np.ndarray) -> bytes:
    """rgb_to_truecolor_halfblocks_scalar (halfblock.c:48-165)."""
    w = rgb.shape[1]
    out = bytearray()
    for top, bot, is_last in _hb_rows(rgb):
        cur_f = None
        cur_b = None
        x = 0
        while x < w:
            t = tuple(int(v) for v in top[x])
            btm = tuple(int(v) for v in bot[x])
            j = x + 1
            while j < w and tuple(int(v) for v in top[j]) == t and tuple(int(v) for v in bot[j]) == btm:
                j += 1
            run = j - x
            transparent = t == (0, 0, 0) and btm == (0, 0, 0)
            if transparent:
                if cur_f is not None or cur_b is not None:
                    out += RESET
                    cur_f = cur_b = None
                out += b" " * run
            else:
                if cur_f != t:
                    out += sgr_truecolor_fg(*t)
                    cur_f = t
                if cur_b != btm:
                    out += sgr_truecolor_bg(*btm)
                    cur_b = btm
                out += HB
                if rep_is_profitable(run):
                    out += emit_rep(run - 1)
                else:
                    out += HB * (run - 1)
            x = j
        out += RESET
        if not is_last:
            out += b"\n"
    return bytes(out)


def _render_halfblock_indexed(rgb: np.ndarray, quant, sgr_fg, sgr_bg) -> bytes:
    """Shared 16/256-color halfblock logic (halfblock.c:297-405 / 416-524):
    runs on quantized (fg,bg) pairs; transparency on raw all-black RGB."""
    w = rgb.shape[1]
    out = bytearray()
    for top, bot, is_last in _hb_rows(rgb):
        cur_f = -1
        cur_b = -1
        x = 0
        while x < w:
            t = tuple(int(v) for v in top[x])
            btm = tuple(int(v) for v in bot[x])
            cf = quant(*t)
            cb = quant(*btm)
            j = x + 1
            while j < w:
                cf2 = quant(*(int(v) for v in top[j]))
                cb2 = quant(*(int(v) for v in bot[j]))
                if cf2 != cf or cb2 != cb:
                    break
                j += 1
            run = j - x
            transparent = t == (0, 0, 0) and btm == (0, 0, 0)
            if transparent:
                if cur_f != -1 or cur_b != -1:
                    out += RESET
                    cur_f = cur_b = -1
                out += b" " * run
            else:
                if cur_f != cf:
                    out += sgr_fg(cf)
                    cur_f = cf
                if cur_b != cb:
                    out += sgr_bg(cb)
                    cur_b = cb
                out += HB
                if rep_is_profitable(run):
                    out += emit_rep(run - 1)
                else:
                    out += HB * (run - 1)
            x = j
        out += RESET
        if not is_last:
            out += b"\n"
    return bytes(out)


def render_halfblock_256(rgb: np.ndarray, palette: str = pal.DEFAULT_PALETTE) -> bytes:
    return _render_halfblock_indexed(rgb, rgb_to_256color, sgr_256_fg, sgr_256_bg)


def render_halfblock_16(rgb: np.ndarray, palette: str = pal.DEFAULT_PALETTE) -> bytes:
    return _render_halfblock_indexed(rgb, rgb_to_16color, sgr_16_fg, sgr_16_bg)


_HB_SHADES = [b"\xe2\x96\x91", b"\xe2\x96\x92", b"\xe2\x96\x93", b"\xe2\x96\x88"]


def render_halfblock_mono(rgb: np.ndarray, palette: str = pal.DEFAULT_PALETTE) -> bytes:
    """rgb_to_halfblocks_scalar (halfblock.c:184-286): luma weights 76/150/29
    with NO rounding constant; runs on exact RGB pair equality; no SGR at all;
    no end-of-line reset."""
    w = rgb.shape[1]
    out = bytearray()
    for top, bot, is_last in _hb_rows(rgb):
        x = 0
        while x < w:
            t = tuple(int(v) for v in top[x])
            btm = tuple(int(v) for v in bot[x])
            j = x + 1
            while j < w and tuple(int(v) for v in top[j]) == t and tuple(int(v) for v in bot[j]) == btm:
                j += 1
            run = j - x
            lum_top = (t[0] * 76 + t[1] * 150 + t[2] * 29) >> 8
            lum_bot = (btm[0] * 76 + btm[1] * 150 + btm[2] * 29) >> 8
            if lum_top < 16 and lum_bot < 16:
                out += b" " * run
            else:
                shade = _HB_SHADES[lum_top >> 6]
                out += shade
                if rep_is_profitable(run):
                    out += emit_rep(run - 1)
                else:
                    out += shade * (run - 1)
            x = j
        if not is_last:
            out += b"\n"
    return bytes(out)


# ---------------------------------------------------------------------------
# Dispatch + full conversion


def image_print_with_capabilities(
    rgb: np.ndarray, caps: TerminalCapabilities, palette: str = pal.DEFAULT_PALETTE
) -> bytes:
    """Renderer dispatch (ascii.c:955-1002 + sgr.c:413-436 fallthrough)."""
    key = caps.renderer_key()
    fns = {
        "halfblock_truecolor": lambda: render_halfblock_truecolor(rgb),
        "halfblock_256": lambda: render_halfblock_256(rgb, palette),
        "halfblock_16": lambda: render_halfblock_16(rgb, palette),
        "halfblock_mono": lambda: render_halfblock_mono(rgb, palette),
        "truecolor_fg": lambda: render_truecolor_fg(rgb, palette),
        "16color_dithered_bg": lambda: render_16color_dithered_bg(rgb, True, palette),
        "256color": lambda: render_256color(rgb, palette),
        "16color": lambda: render_16color(rgb, palette),
        "mono": lambda: render_mono(rgb, palette),
    }
    return fns[key]()


def resize_image(rgb: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """image_resize_interpolation semantics (image.c:267-328)."""
    sy = resize_indices(rgb.shape[0], dst_h)
    sx = resize_indices(rgb.shape[1], dst_w)
    return rgb[sy][:, sx]


def pad_frame_width(frame: bytes, pad_left: int) -> bytes:
    """ascii_pad_frame_width (ascii.c:457-517): spaces before every visual row."""
    if pad_left == 0:
        return frame
    out = bytearray()
    at_line_start = True
    for ch in frame:
        if at_line_start:
            out += b" " * pad_left
            at_line_start = False
        out.append(ch)
        if ch == 0x0A:
            at_line_start = True
    return bytes(out)


def pad_frame_height(frame: bytes, pad_top: int) -> bytes:
    """ascii_pad_frame_height (ascii.c:902-941): plain '\\n' rows on top."""
    return b"\n" * pad_top + frame


def compute_render_geometry(
    src_w: int,
    src_h: int,
    width: int,
    height: int,
    caps: TerminalCapabilities,
    use_aspect_ratio: bool = True,
    stretch: bool = False,
) -> tuple[int, int, int, int]:
    """(resized_w, resized_h_px, pad_w, pad_h) per ascii.c:214-253.

    Half-block doubles the pixel height AFTER aspect fitting; padding is
    computed in output-row space (pre-doubling) and only when wants_padding.
    """
    resized_w, resized_h = width, height
    if use_aspect_ratio:
        resized_w, resized_h = aspect_ratio(src_w, src_h, width, height, stretch)
    out_w, out_h = resized_w, resized_h
    if caps.render_mode == RenderMode.HALF_BLOCK:
        resized_h *= 2
    pad_w = pad_h = 0
    if use_aspect_ratio and caps.wants_padding:
        pad_w = (width - out_w) // 2 if width > out_w else 0
        pad_h = (height - out_h) // 2 if height > out_h else 0
    return resized_w, resized_h, pad_w, pad_h


def ascii_convert_with_capabilities(
    rgb: np.ndarray,
    width: int,
    height: int,
    caps: TerminalCapabilities,
    use_aspect_ratio: bool = True,
    stretch: bool = False,
    palette: str = pal.DEFAULT_PALETTE,
) -> bytes:
    """Full oracle conversion (ascii.c:194-387)."""
    src_h, src_w = rgb.shape[:2]
    rw, rh, pad_w, pad_h = compute_render_geometry(
        src_w, src_h, width, height, caps, use_aspect_ratio, stretch
    )
    resized = resize_image(rgb, rw, rh)
    frame = image_print_with_capabilities(resized, caps, palette)
    frame = pad_frame_width(frame, pad_w)
    frame = pad_frame_height(frame, pad_h)
    return frame
