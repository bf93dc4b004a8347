/* ACIP wire protocol in the browser: packet framing + CRC32-C + payload
 * builders. Mirrors net/packet.py (22-byte header, magic 0xA5C11C4A1) and
 * net/protocol.py (CAPS_STRUCT ">IIIIHH32s32sBII64sBBBII", 168 bytes).
 * Reference: include/ascii-chat/network/packet/packet.h:600-610.
 */
"use strict";

(function (exports) {
  // table-driven CRC32-C (Castagnoli) — 8x faster than the bitwise loop
  const CRC_TABLE = (() => {
    const t = new Uint32Array(256);
    for (let n = 0; n < 256; n++) {
      let c = n;
      for (let k = 0; k < 8; k++) c = (c >>> 1) ^ (0x82f63b78 & -(c & 1));
      t[n] = c >>> 0;
    }
    return t;
  })();

  function crc32c(bytes) {
    let crc = 0xffffffff;
    for (let i = 0; i < bytes.length; i++)
      crc = (crc >>> 8) ^ CRC_TABLE[(crc ^ bytes[i]) & 255];
    return (~crc) >>> 0;
  }

  const HEADER_SIZE = 22;

  const T = {
    SIZE_MESSAGE: 2000,
    TEXT_MESSAGE: 2002,
    ASCII_FRAME: 3000,
    IMAGE_FRAME: 3001,
    AUDIO_BATCH: 4000,
    CLIENT_CAPABILITIES: 5000,
    PING: 5001,
    PONG: 5002,
    CLIENT_JOIN: 5003,
    CLIENT_LEAVE: 5004,
    CLEAR_CONSOLE: 5007,
    SERVER_STATE: 5008,
  };

  function packPacket(type, payload) {
    const buf = new ArrayBuffer(HEADER_SIZE + payload.length);
    const dv = new DataView(buf);
    dv.setUint32(0, 0x0000000a); // magic 0xA5C11C4A1 as u64 big-endian
    dv.setUint32(4, 0x5c11c4a1);
    dv.setUint16(8, type);
    dv.setUint32(10, payload.length);
    dv.setUint32(14, payload.length ? crc32c(payload) : 0);
    dv.setUint32(18, 0); // client_id (assigned server-side)
    new Uint8Array(buf, HEADER_SIZE).set(payload);
    return buf;
  }

  function unpackHeader(dv) {
    return { type: dv.getUint16(8), length: dv.getUint32(10) };
  }

  /* terminal_capabilities_packet_t (net/protocol.CAPS_STRUCT, 168 bytes).
   * settings: {cols, rows, colorLevel, renderMode, paletteCustom,
   *            desiredFps, colorFilter} */
  function capsPayload(s) {
    const buf = new ArrayBuffer(168);
    const dv = new DataView(buf);
    const u8 = new Uint8Array(buf);
    const enc = new TextEncoder();
    dv.setUint32(0, 1); // capabilities mask: bit0 = no-zstd (browser)
    dv.setUint32(4, s.colorLevel >>> 0); // 3=truecolor 2=256 1=16 0=mono
    dv.setUint32(8, [2, 16, 256, 16777216][s.colorLevel] || 16777216);
    dv.setUint32(12, s.renderMode); // 0=FG 1=BG 2=HALF_BLOCK
    dv.setUint16(16, s.cols);
    dv.setUint16(18, s.rows);
    const term = enc.encode("xterm-web");
    u8.set(term.subarray(0, 32), 20);
    const colorterm = enc.encode(s.colorLevel === 3 ? "truecolor" : "");
    u8.set(colorterm.subarray(0, 32), 52);
    dv.setUint8(84, 1); // detection_reliable
    dv.setUint32(85, 1); // utf8
    dv.setUint32(89, 0); // palette_type
    const pc = enc.encode(s.paletteCustom || "");
    u8.set(pc.subarray(0, 64), 93);
    dv.setUint8(157, s.desiredFps || 60);
    dv.setUint8(158, s.colorFilter || 0);
    dv.setUint8(159, 1); // wants_padding
    dv.setUint8(160, 0); // codec_video (u32 @160)
    return u8;
  }

  function sizePayload(cols, rows) {
    const b = new Uint8Array(4);
    const dv = new DataView(b.buffer);
    dv.setUint16(0, cols);
    dv.setUint16(2, rows);
    return b;
  }

  /* ascii_frame header: u32 w, h, original_size, compressed_size, crc, flags */
  function parseAsciiFrame(payload) {
    const dv = new DataView(payload.buffer, payload.byteOffset, payload.byteLength);
    return {
      width: dv.getUint32(0),
      height: dv.getUint32(4),
      originalSize: dv.getUint32(8),
      compressedSize: dv.getUint32(12),
      body: payload.subarray(24),
    };
  }

  /* image_frame: u32 w, h, pixel_format(0=RGB24), reserved, crc, seq */
  function imageFramePayload(rgb, w, h) {
    const out = new Uint8Array(24 + rgb.length);
    const dv = new DataView(out.buffer);
    dv.setUint32(0, w);
    dv.setUint32(4, h);
    dv.setUint32(8, 0);
    dv.setUint32(12, 0);
    dv.setUint32(16, crc32c(rgb));
    dv.setUint32(20, Date.now() % 0xffffffff);
    out.set(rgb, 24);
    return out;
  }

  /* audio batch: u32 batch_count, total_samples, rate, channels + f32le */
  function audioBatchPayload(samples, rate) {
    const out = new Uint8Array(16 + samples.length * 4);
    const dv = new DataView(out.buffer);
    dv.setUint32(0, 1);
    dv.setUint32(4, samples.length);
    dv.setUint32(8, rate);
    dv.setUint32(12, 1);
    for (let i = 0; i < samples.length; i++)
      dv.setFloat32(16 + i * 4, samples[i], true);
    return out;
  }

  function parseAudioBatch(payload) {
    const dv = new DataView(payload.buffer, payload.byteOffset, payload.byteLength);
    // clamp the declared count to what the payload actually carries: a
    // short/corrupt packet must not throw a RangeError out of onmessage
    const carried = payload.byteLength >= 16 ? (payload.byteLength - 16) >> 2 : 0;
    const total = Math.min(dv.getUint32(4), carried);
    const rate = dv.getUint32(8) || 48000;
    const samples = new Float32Array(total);
    for (let i = 0; i < total; i++) samples[i] = dv.getFloat32(16 + i * 4, true);
    return { samples, rate };
  }

  exports.T = T;
  exports.crc32c = crc32c;
  exports.HEADER_SIZE = HEADER_SIZE;
  exports.packPacket = packPacket;
  exports.unpackHeader = unpackHeader;
  exports.capsPayload = capsPayload;
  exports.sizePayload = sizePayload;
  exports.parseAsciiFrame = parseAsciiFrame;
  exports.imageFramePayload = imageFramePayload;
  exports.audioBatchPayload = audioBatchPayload;
  exports.parseAudioBatch = parseAudioBatch;
})(typeof module !== "undefined" && module.exports ? module.exports
   : (globalThis.AsciichatAcip = {}));
