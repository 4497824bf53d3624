// ANSI frame encoder: chexel grids -> one escape-sequence byte stream.
//
// Copied from yetanotherconsolegameengine_tpu/native/ansi_encoder.cpp.
// Native counterpart of the C# ANSITerminalRenderer hot path
// (Renderer/ANSITerminalRenderer.cs:86-242):
// per row a cursor seek "\x1b[y;1H", per cell SGR 38;5;n / 48;5;m emitted
// ONLY when the color index changes (run-length state machine), manual
// UTF-8 glyph encoding, and the whole frame written with a single write(2)
// by the Python caller. C++ because this is the only per-cell host loop
// left in the pipeline; everything upstream runs on the card.
//
// Exposed via ctypes (no pybind11 in this image). All arrays are C-order
// (h, w) int32.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

inline int put_bytes(uint8_t* out, int pos, const char* s, int n) {
    memcpy(out + pos, s, n);
    return pos + n;
}

inline int put_uint(uint8_t* out, int pos, int v) {
    char tmp[12];
    int n = snprintf(tmp, sizeof tmp, "%d", v);
    return put_bytes(out, pos, tmp, n);
}

inline int put_utf8(uint8_t* out, int pos, uint32_t cp) {
    if (cp < 0x80) {
        out[pos++] = (uint8_t)cp;
    } else if (cp < 0x800) {
        out[pos++] = (uint8_t)(0xC0 | (cp >> 6));
        out[pos++] = (uint8_t)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
        out[pos++] = (uint8_t)(0xE0 | (cp >> 12));
        out[pos++] = (uint8_t)(0x80 | ((cp >> 6) & 0x3F));
        out[pos++] = (uint8_t)(0x80 | (cp & 0x3F));
    } else {
        out[pos++] = (uint8_t)(0xF0 | (cp >> 18));
        out[pos++] = (uint8_t)(0x80 | ((cp >> 12) & 0x3F));
        out[pos++] = (uint8_t)(0x80 | ((cp >> 6) & 0x3F));
        out[pos++] = (uint8_t)(0x80 | (cp & 0x3F));
    }
    return pos;
}

}  // namespace

extern "C" {

// Worst-case bytes per cell (seek + 2 SGRs + 4-byte glyph) for sizing.
int yacge_ansi_max_bytes(int w, int h) {
    return h * (12 + w * (12 + 12 + 4)) + 64;
}

// Encode a full frame. glyphs/fg/bg: (h, w) int32; fg/bg are ANSI-256
// indices. origin_row is the 1-based terminal row of the first grid row.
// Returns the number of bytes written to out.
int yacge_ansi_encode(const int32_t* glyphs, const int32_t* fg,
                      const int32_t* bg, int w, int h, int origin_row,
                      uint8_t* out) {
    int pos = 0;
    int cur_fg = -1, cur_bg = -1;
    for (int y = 0; y < h; ++y) {
        // Row seek: \x1b[{row};1H  (ANSITerminalRenderer row addressing).
        pos = put_bytes(out, pos, "\x1b[", 2);
        pos = put_uint(out, pos, origin_row + y);
        pos = put_bytes(out, pos, ";1H", 3);
        const int32_t* gr = glyphs + (size_t)y * w;
        const int32_t* fr = fg + (size_t)y * w;
        const int32_t* br = bg + (size_t)y * w;
        for (int x = 0; x < w; ++x) {
            if (fr[x] != cur_fg) {
                cur_fg = fr[x];
                pos = put_bytes(out, pos, "\x1b[38;5;", 7);
                pos = put_uint(out, pos, cur_fg);
                out[pos++] = 'm';
            }
            if (br[x] != cur_bg) {
                cur_bg = br[x];
                pos = put_bytes(out, pos, "\x1b[48;5;", 7);
                pos = put_uint(out, pos, cur_bg);
                out[pos++] = 'm';
            }
            pos = put_utf8(out, pos, (uint32_t)gr[x]);
        }
    }
    pos = put_bytes(out, pos, "\x1b[0m", 4);
    return pos;
}

// Diff encoder: emits only cells that changed vs (prev_glyphs/fg/bg).
// Seeks per dirty run instead of per row. Returns bytes written, or -1 if
// nothing changed.
int yacge_ansi_encode_diff(const int32_t* glyphs, const int32_t* fg,
                           const int32_t* bg, const int32_t* pglyphs,
                           const int32_t* pfg, const int32_t* pbg,
                           int w, int h, int origin_row, uint8_t* out) {
    int pos = 0;
    int cur_fg = -1, cur_bg = -1;
    bool any = false;
    for (int y = 0; y < h; ++y) {
        const size_t row = (size_t)y * w;
        const int32_t* gr = glyphs + row;
        const int32_t* fr = fg + row;
        const int32_t* br = bg + row;
        const int32_t* pgr = pglyphs + row;
        const int32_t* pfr = pfg + row;
        const int32_t* pbr = pbg + row;
        int x = 0;
        while (x < w) {
            // Skip clean cells.
            while (x < w && gr[x] == pgr[x] && fr[x] == pfr[x]
                   && br[x] == pbr[x])
                ++x;
            if (x >= w) break;
            any = true;
            // Seek to the dirty run start.
            pos = put_bytes(out, pos, "\x1b[", 2);
            pos = put_uint(out, pos, origin_row + y);
            out[pos++] = ';';
            pos = put_uint(out, pos, x + 1);
            out[pos++] = 'H';
            // Emit until a run of >=8 clean cells (seeks cost ~8 bytes).
            while (x < w) {
                int clean = 0;
                while (x + clean < w && gr[x + clean] == pgr[x + clean]
                       && fr[x + clean] == pfr[x + clean]
                       && br[x + clean] == pbr[x + clean])
                    ++clean;
                if (clean >= 8 || x + clean >= w) break;
                for (int k = 0; k < clean; ++k) {  // re-emit cheap clean gap
                    if (fr[x] != cur_fg) {
                        cur_fg = fr[x];
                        pos = put_bytes(out, pos, "\x1b[38;5;", 7);
                        pos = put_uint(out, pos, cur_fg);
                        out[pos++] = 'm';
                    }
                    if (br[x] != cur_bg) {
                        cur_bg = br[x];
                        pos = put_bytes(out, pos, "\x1b[48;5;", 7);
                        pos = put_uint(out, pos, cur_bg);
                        out[pos++] = 'm';
                    }
                    pos = put_utf8(out, pos, (uint32_t)gr[x]);
                    ++x;
                }
                // Dirty cell.
                if (fr[x] != cur_fg) {
                    cur_fg = fr[x];
                    pos = put_bytes(out, pos, "\x1b[38;5;", 7);
                    pos = put_uint(out, pos, cur_fg);
                    out[pos++] = 'm';
                }
                if (br[x] != cur_bg) {
                    cur_bg = br[x];
                    pos = put_bytes(out, pos, "\x1b[48;5;", 7);
                    pos = put_uint(out, pos, cur_bg);
                    out[pos++] = 'm';
                }
                pos = put_utf8(out, pos, (uint32_t)gr[x]);
                ++x;
            }
        }
    }
    if (!any) return -1;
    pos = put_bytes(out, pos, "\x1b[0m", 4);
    return pos;
}

}  // extern "C"
