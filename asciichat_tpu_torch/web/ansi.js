/* ANSI SGR frame -> cell grid parser (the browser render core).
 *
 * Parses a full ASCII_FRAME payload ONCE per frame into flat typed arrays
 * (glyph codepoint, packed fg, packed bg per cell) instead of regexing the
 * text into per-frame DOM/HTML. This is the parse-side counterpart of the
 * reference's WASM render core (src/web/main_wasm.c): allocation-free after
 * warmup, single pass, no regex.
 *
 * Grammar (exactly the oracle/emitter output, render/oracle.py and
 * reference lib/video/ascii/output_buffer.c:107-164, terminal/ansi.c:360-583):
 *   ESC[38;2;R;G;Bm  truecolor fg        ESC[48;2;R;G;Bm  truecolor bg
 *   ESC[38;5;Nm      256-color fg        ESC[48;5;Nm      256-color bg
 *   ESC[30-37m / ESC[90-97m   16-color fg
 *   ESC[40-47m / ESC[100-107m 16-color bg
 *   ESC[0m / ESC[m   reset               ESC[<n>b  REP (repeat last glyph)
 *   \n               next row; other CSI finals are ignored.
 *
 * Cell encoding: fg/bg are 0xRRGGBB ints, -1 = none/default. A structurally
 * identical Python twin lives in asciichat_tpu/web/ansiparse.py and is
 * golden-tested against the oracle renderers; keep the two in sync.
 */
"use strict";

(function (exports) {
  // 16-color ANSI palette (reference ansi.c:442-459; also xterm256 0-15)
  const ANSI16 = [
    0x000000, 0x800000, 0x008000, 0x808000,
    0x000080, 0x800080, 0x008080, 0xc0c0c0,
    0x808080, 0xff0000, 0x00ff00, 0xffff00,
    0x0000ff, 0xff00ff, 0x00ffff, 0xffffff,
  ];
  const CUBE = [0, 95, 135, 175, 215, 255];

  function xterm256(n) {
    if (n < 16) return ANSI16[n & 15];
    if (n < 232) {
      const c = n - 16;
      return (CUBE[(c / 36) | 0] << 16) | (CUBE[((c / 6) | 0) % 6] << 8) | CUBE[c % 6];
    }
    const v = 8 + (n - 232) * 10;
    return (v << 16) | (v << 8) | v;
  }

  const SPACE = 32;

  class AnsiGrid {
    constructor(capW, capH) {
      this.capW = capW || 256;
      this.capH = capH || 128;
      this._alloc();
      this.w = 0;
      this.h = 0;
      this.allHalfblock = true; // every visible glyph is U+2580 or space
    }

    _alloc() {
      // default-fill the WHOLE capacity (typed arrays zero-fill, which is
      // NOT the default cell): parse() only re-clears the previously-used
      // region, so untouched cells must already read space/-1/-1 — this
      // matches the np.full initialization in the Python twin
      const n = this.capW * this.capH;
      this.glyphs = new Uint32Array(n).fill(SPACE);
      this.fg = new Int32Array(n).fill(-1);
      this.bg = new Int32Array(n).fill(-1);
    }

    /** Parse one decoded frame string into the grid. Returns this. */
    parse(text) {
      let capW = this.capW, capH = this.capH;
      // clear the region the previous frame used (memset-cheap)
      const used = capW * Math.min(this.h + 1, capH);
      this.glyphs.fill(SPACE, 0, used);
      this.fg.fill(-1, 0, used);
      this.bg.fill(-1, 0, used);
      const glyphs = this.glyphs, fgArr = this.fg, bgArr = this.bg;
      let fg = -1, bg = -1;
      let row = 0, col = 0, maxCol = 0;
      let lastGlyph = SPACE, lastFg = -1, lastBg = -1;
      let allHb = true;
      const len = text.length;
      let i = 0;
      while (i < len) {
        const c = text.charCodeAt(i);
        if (c === 0x1b && i + 1 < len && text.charCodeAt(i + 1) === 0x5b) {
          // CSI: accumulate numeric params without allocating. Params are
          // capped at 5 (the longest oracle-grammar form, 38;2;R;G;B) —
          // extras are ignored, IDENTICALLY to the Python twin.
          let j = i + 2;
          let p0 = -1, p1 = -1, p2 = -1, p3 = -1, p4 = -1; // up to 5 params
          let num = -1, np = 0, fin = 0;
          for (; j < len; j++) {
            const d = text.charCodeAt(j);
            if (d >= 48 && d <= 57) {
              num = (num < 0 ? 0 : num) * 10 + (d - 48);
            } else if (d === 59) { // ';'
              const v = num < 0 ? 0 : num;
              if (np === 0) p0 = v; else if (np === 1) p1 = v;
              else if (np === 2) p2 = v; else if (np === 3) p3 = v;
              else if (np === 4) p4 = v;
              np++;
              num = -1;
            } else { fin = d; break; }
          }
          // close the trailing param
          if (num >= 0) {
            if (np === 0) p0 = num; else if (np === 1) p1 = num;
            else if (np === 2) p2 = num; else if (np === 3) p3 = num;
            else if (np === 4) p4 = num;
            np++;
          }
          if (np > 5) np = 5;
          if (fin === 0x6d) { // 'm' — SGR (branch conditions mirror the twin)
            if (np === 0) { fg = -1; bg = -1; }
            else if (np === 5 && p0 === 38 && p1 === 2) fg = ((p2 & 255) << 16) | ((p3 & 255) << 8) | (p4 & 255);
            else if (np === 5 && p0 === 48 && p1 === 2) bg = ((p2 & 255) << 16) | ((p3 & 255) << 8) | (p4 & 255);
            else if (np === 3 && p0 === 38 && p1 === 5) fg = xterm256(p2 & 255);
            else if (np === 3 && p0 === 48 && p1 === 5) bg = xterm256(p2 & 255);
            else {
              // short SGR lists (0, 16-color codes); walk the few params
              const ps = [p0, p1, p2, p3, p4];
              for (let k = 0; k < np; k++) {
                const p = ps[k];
                if (p === 0) { fg = -1; bg = -1; }
                else if (p >= 30 && p <= 37) fg = ANSI16[p - 30];
                else if (p >= 90 && p <= 97) fg = ANSI16[p - 90 + 8];
                else if (p >= 40 && p <= 47) bg = ANSI16[p - 40];
                else if (p >= 100 && p <= 107) bg = ANSI16[p - 100 + 8];
              }
            }
          } else if (fin === 0x62) { // 'b' — REP: repeat last glyph n times
            let n = p0 < 0 ? 0 : p0;
            // REP triggers the same grid-doubling realloc a literal glyph
            // gets — truncating at capW lost the right side of uniform
            // rows wider than the initial capacity (lockstep with
            // ansiparse.py — shared corpus contract)
            if (n > 0 && col + Math.min(n, 4096) > capW && row < capH) {
              this.capW = capW * 2; this._alloc(); return this.parse(text);
            }
            while (n-- > 0 && col < capW && row < capH) {
              const at = row * capW + col;
              glyphs[at] = lastGlyph; fgArr[at] = lastFg; bgArr[at] = lastBg;
              col++;
            }
            if (col > maxCol) maxCol = col;
          } // other finals (H, J, K...) are ignored
          i = j + 1;
          continue;
        }
        if (c === 10) { // '\n'
          row++;
          col = 0;
          if (row >= capH) { this.capH = capH * 2; this._alloc(); return this.parse(text); }
          i++;
          continue;
        }
        // visible glyph (handle surrogate pairs for astral codepoints)
        let cp = c;
        if (c >= 0xd800 && c <= 0xdbff && i + 1 < len) {
          cp = text.codePointAt(i);
          i++;
        }
        if (col >= capW) { this.capW = capW * 2; this._alloc(); return this.parse(text); }
        const at = row * capW + col;
        glyphs[at] = cp; fgArr[at] = fg; bgArr[at] = bg;
        lastGlyph = cp; lastFg = fg; lastBg = bg;
        if (cp !== SPACE && cp !== 0x2580) allHb = false;
        col++;
        if (col > maxCol) maxCol = col;
        i++;
      }
      this.w = maxCol;
      // the oracle never emits a trailing newline, so h = row + 1
      this.h = row + 1;
      this.allHalfblock = allHb;
      return this;
    }

    cell(x, y) {
      const at = y * this.capW + x;
      return [this.glyphs[at], this.fg[at], this.bg[at]];
    }
  }

  exports.AnsiGrid = AnsiGrid;
  exports.xterm256 = xterm256;
  exports.ANSI16 = ANSI16;
})(typeof module !== "undefined" && module.exports ? module.exports
   : (globalThis.AsciichatAnsi = {}));
