/* Cell-grid -> canvas renderer (the draw side of the browser render core).
 *
 * Two paths, picked automatically per frame:
 *
 * 1. PIXEL path (half-block frames, grid.allHalfblock): every cell is
 *    U+2580 (fg = top pixel, bg = bottom pixel) or a space, so the frame
 *    IS a W x 2H image. We write it into an ImageData once (typed-array
 *    stores, no text layout at all) and blit it scaled with
 *    imageSmoothingEnabled=false — one draw call for the whole frame.
 *    This is the canvas-blit architecture the reference's web app uses for
 *    its WASM-rendered frames (web/packages + src/web/main_wasm.c).
 *
 * 2. CELL path (glyph frames): diff against the previous grid and redraw
 *    only changed cells: bg rect + fillText glyph. fillStyle is only
 *    switched when the color actually changes (SGR-run-shaped frames make
 *    this cheap).
 */
"use strict";

(function (exports) {
  const SPACE = 32, HB = 0x2580;

  class CanvasRenderer {
    constructor(canvas, opts) {
      opts = opts || {};
      this.canvas = canvas;
      this.ctx = canvas.getContext("2d", { alpha: false });
      this.defaultFg = opts.defaultFg || 0xcccccc;
      this.defaultBg = opts.defaultBg || 0x000000;
      this.setFont(opts.fontPx || 14, opts.fontFamily ||
        "'SF Mono', 'DejaVu Sans Mono', Menlo, Consolas, monospace");
      this.prevGlyphs = null;
      this.prevFg = null;
      this.prevBg = null;
      this.gridW = 0;
      this.gridH = 0;
      this._img = null; // ImageData for the pixel path
      this._off = null; // offscreen canvas holding the W x 2H image
      this.lastMode = "";
    }

    setFont(px, family) {
      this.fontPx = px;
      this.fontFamily = family || this.fontFamily;
      this.font = `${px}px ${this.fontFamily}`;
      const probe = document.createElement("canvas").getContext("2d");
      probe.font = this.font;
      const m = probe.measureText("M");
      this.cellW = Math.ceil(m.width);
      this.cellH = Math.ceil(px * 1.2);
      this.baseline = Math.round(px * 0.95);
      this.prevGlyphs = null; // force full redraw
    }

    _css(packed, fallback) {
      const v = packed < 0 ? fallback : packed;
      return `rgb(${(v >> 16) & 255},${(v >> 8) & 255},${v & 255})`;
    }

    _resize(w, h) {
      this.gridW = w;
      this.gridH = h;
      this.canvas.width = w * this.cellW;
      this.canvas.height = h * this.cellH;
      this.prevGlyphs = null;
    }

    /** Draw a parsed AnsiGrid. Returns the draw path used ("pixel"|"cells"). */
    draw(grid) {
      const w = grid.w, h = grid.h;
      if (w === 0 || h === 0) return "empty";
      if (w !== this.gridW || h !== this.gridH) this._resize(w, h);
      if (grid.allHalfblock) {
        this._drawPixels(grid);
        this.prevGlyphs = null; // cell diff state is stale now
        return (this.lastMode = "pixel");
      }
      this._drawCells(grid);
      return (this.lastMode = "cells");
    }

    _drawPixels(grid) {
      const w = grid.w, h = grid.h, stride = grid.capW;
      if (!this._img || this._img.width !== w || this._img.height !== 2 * h) {
        this._off = document.createElement("canvas");
        this._off.width = w;
        this._off.height = 2 * h;
        this._offCtx = this._off.getContext("2d");
        this._img = this._offCtx.createImageData(w, 2 * h);
        this._img.data.fill(255); // opaque alpha once
      }
      const d = this._img.data;
      const defTop = this.defaultBg, defBot = this.defaultBg;
      for (let y = 0; y < h; y++) {
        let top = (y * 2) * w * 4;
        let bot = (y * 2 + 1) * w * 4;
        let at = y * stride;
        for (let x = 0; x < w; x++, at++, top += 4, bot += 4) {
          let f = grid.fg[at], b = grid.bg[at];
          if (grid.glyphs[at] === SPACE) { f = defTop; b = defBot; }
          else { if (f < 0) f = defTop; if (b < 0) b = defBot; }
          d[top] = (f >> 16) & 255; d[top + 1] = (f >> 8) & 255; d[top + 2] = f & 255;
          d[bot] = (b >> 16) & 255; d[bot + 1] = (b >> 8) & 255; d[bot + 2] = b & 255;
        }
      }
      this._offCtx.putImageData(this._img, 0, 0);
      this.ctx.imageSmoothingEnabled = false;
      this.ctx.drawImage(this._off, 0, 0, this.canvas.width, this.canvas.height);
    }

    _drawCells(grid) {
      const ctx = this.ctx;
      const w = grid.w, h = grid.h, stride = grid.capW;
      const cw = this.cellW, ch = this.cellH;
      const full = this.prevGlyphs === null ||
        this.prevGlyphs.length !== grid.glyphs.length;
      if (full) {
        ctx.fillStyle = this._css(-1, this.defaultBg);
        ctx.fillRect(0, 0, this.canvas.width, this.canvas.height);
        this.prevGlyphs = new Uint32Array(grid.glyphs.length);
        this.prevFg = new Int32Array(grid.fg.length);
        this.prevBg = new Int32Array(grid.bg.length);
        this.prevGlyphs.fill(SPACE);
        this.prevFg.fill(-1);
        this.prevBg.fill(-2); // never matches: every cell redraws once
      }
      ctx.font = this.font;
      ctx.textBaseline = "alphabetic";
      let curStyle = null;
      const setStyle = (s) => { if (s !== curStyle) { ctx.fillStyle = s; curStyle = s; } };
      const pg = this.prevGlyphs, pf = this.prevFg, pb = this.prevBg;
      for (let y = 0; y < h; y++) {
        let at = y * stride;
        for (let x = 0; x < w; x++, at++) {
          const g = grid.glyphs[at], f = grid.fg[at], b = grid.bg[at];
          if (pg[at] === g && pf[at] === f && pb[at] === b) continue;
          pg[at] = g; pf[at] = f; pb[at] = b;
          const px = x * cw, py = y * ch;
          setStyle(this._css(b, this.defaultBg));
          ctx.fillRect(px, py, cw, ch);
          if (g === SPACE) continue;
          if (g === HB) { // lone half-block amid glyphs: top-half rect
            setStyle(this._css(f, this.defaultFg));
            ctx.fillRect(px, py, cw, ch / 2);
            continue;
          }
          setStyle(this._css(f, this.defaultFg));
          ctx.fillText(String.fromCodePoint(g), px, py + this.baseline);
        }
      }
    }
  }

  exports.CanvasRenderer = CanvasRenderer;
})(typeof module !== "undefined" && module.exports ? module.exports
   : (globalThis.AsciichatRenderer = {}));
