// Native FASTA/FASTQ/gz chunk reader + 2-bit encoder.
//
// This is the TPU framework's equivalent of jellyfish's
// mer_overlap_sequence_parser (reference deps/jellyfish-2.2.0/include/
// jellyfish/mer_overlap_sequence_parser.hpp) + stream_manager
// (stream_manager.hpp) + cooperative_pool2's many-consumers-one-stream
// idea (cooperative_pool2.hpp:28-50): it streams records out of
// (optionally gzipped) FASTA/FASTQ files and packs their bases, already
// 2-bit encoded, densely into fixed-shape [rows, row_len] uint8 matrices
// for the device:
//
//   - records are concatenated with ONE invalid code (4) between them, so
//     k-windows never span records (the role of the parser's record
//     boundary handling);
//   - a record split across rows repeats its last (k-1) bases at the start
//     of the next row — the "seam" of mer_overlap_sequence_parser.hpp:44-52
//     — so no k-window is lost;
//   - rows are padded with code 5 (also invalid) only at end-of-file.
//
// Single-file parallelism (the reference drains ONE stream with N
// cooperating consumers; here N range readers own disjoint record sets):
//
//   - kat_fastx_open_range(path, trim5, start, end): a reader over the
//     records whose header byte lies in [start, end) of an UNCOMPRESSED
//     file.  Record-boundary sync scans forward from `start` for the
//     first '\n'-preceded header ('>' for FASTA; for FASTQ a '@' line
//     verified by the '+' two lines later — quality lines starting with
//     '@' are rejected because a sequence line can never start '+').
//     Records never span readers, so no k-window is lost or duplicated.
//   - kat_fastx_open_threaded(path, trim5): inflate (gzread) runs on a
//     dedicated producer thread into a double buffer while the parser
//     consumes — a plain .gz stream is inherently serial to decompress,
//     so pipelining parse behind inflate is the honest ceiling for one
//     gzip member.
//
// Exposed as a tiny C ABI consumed via ctypes (no pybind11 in this image).
// Build: g++ -O3 -march=native -shared -fPIC fastxio.cpp -o libfastxio.so
//        -lz -lpthread

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int INVALID = 4;  // record separator / non-ACGT
constexpr int PAD = 5;      // end-of-stream padding

struct CodeLut {
  uint8_t lut[256];
  CodeLut() {
    std::memset(lut, INVALID, sizeof(lut));
    lut[static_cast<int>('A')] = 0;
    lut[static_cast<int>('a')] = 0;
    lut[static_cast<int>('C')] = 1;
    lut[static_cast<int>('c')] = 1;
    lut[static_cast<int>('G')] = 2;
    lut[static_cast<int>('g')] = 2;
    lut[static_cast<int>('T')] = 3;
    lut[static_cast<int>('t')] = 3;
  }
};
const CodeLut kLut;

// Raw-deflate gzip reader for the threaded producer: parses the gzip
// member header by hand and inflates with windowBits=-15, which SKIPS
// zlib's incremental crc32 of the decompressed stream (~20-30% of
// single-stream inflate time).  The 8-byte member trailer (crc32 +
// isize) is deliberately NOT validated — the k-mer pipelines verify
// content semantically (oracle/golden parity) and the serial checksum
// would put the saving right back.  Multi-member (concatenated /
// bgzf-style) files are handled by re-parsing a header after each
// Z_STREAM_END.  Falls back to gzread on any header anomaly.
struct RawGz {
  FILE* fp = nullptr;
  z_stream zs{};
  bool live = false;      // zs initialised and mid-member
  bool failed = false;    // fall back to gzread
  static constexpr size_t CBUF = 1 << 20;
  unsigned char in[CBUF];

  bool refill() {
    if (zs.avail_in > 0) return true;
    size_t n = fread(in, 1, CBUF, fp);
    zs.next_in = in;
    zs.avail_in = static_cast<uInt>(n);
    return n > 0;
  }

  int byte() {  // next compressed byte, -1 at EOF
    if (!refill()) return -1;
    --zs.avail_in;
    return *zs.next_in++;
  }

  // Parse one gzip member header starting at the current position.
  // Returns 1 ok, 0 clean EOF (no more members), -1 malformed.
  int parse_header() {
    int b0 = byte();
    if (b0 < 0) return 0;
    int b1 = byte();
    if (b0 != 0x1f || b1 != 0x8b) return -1;
    if (byte() != 8) return -1;  // CM: deflate
    int flg = byte();
    if (flg < 0 || (flg & 0xe0)) return -1;  // reserved bits
    for (int i = 0; i < 6; ++i)              // MTIME + XFL + OS
      if (byte() < 0) return -1;
    if (flg & 4) {  // FEXTRA
      int x0 = byte(), x1 = byte();
      if (x0 < 0 || x1 < 0) return -1;
      for (int i = 0; i < x0 + (x1 << 8); ++i)
        if (byte() < 0) return -1;
    }
    if (flg & 8)   // FNAME: NUL-terminated
      for (int c = byte(); c != 0; c = byte())
        if (c < 0) return -1;
    if (flg & 16)  // FCOMMENT
      for (int c = byte(); c != 0; c = byte())
        if (c < 0) return -1;
    if (flg & 2)   // FHCRC
      if (byte() < 0 || byte() < 0) return -1;
    return 1;
  }

  bool open(const char* path) {
    fp = fopen(path, "rb");
    if (!fp) return false;
    zs.next_in = in;
    zs.avail_in = 0;
    int h = parse_header();
    if (h != 1 || inflateInit2(&zs, -15) != Z_OK) {
      fclose(fp);
      fp = nullptr;
      return false;
    }
    live = true;
    return true;
  }

  // Inflate up to `cap` bytes into `out`; 0 = EOF, -1 = error.
  long read(unsigned char* out, size_t cap) {
    if (failed || !live) return failed ? -1 : 0;
    zs.next_out = out;
    zs.avail_out = static_cast<uInt>(cap);
    while (zs.avail_out > 0) {
      if (!refill() && zs.avail_in == 0) {
        failed = true;  // truncated member
        return -1;
      }
      int rc = inflate(&zs, Z_NO_FLUSH);
      if (rc == Z_STREAM_END) {
        for (int i = 0; i < 8; ++i)  // trailer: crc32+isize, unvalidated
          if (byte() < 0) {
            failed = true;
            return -1;
          }
        int h = parse_header();
        if (h <= 0) {  // EOF, or trailing garbage after the last member
          live = false;  // (zlib's gzread ignores trailing garbage too)
          break;
        }
        if (inflateReset2(&zs, -15) != Z_OK) {
          failed = true;
          return -1;
        }
      } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
        failed = true;
        return -1;
      } else if (rc == Z_BUF_ERROR && zs.avail_in == 0 && !refill()) {
        failed = true;
        return -1;
      }
    }
    return static_cast<long>(cap - zs.avail_out);
  }

  ~RawGz() {
    if (live || fp) inflateEnd(&zs);
    if (fp) fclose(fp);
  }
};

struct Reader {
  gzFile f = nullptr;
  // buffered input
  static constexpr size_t BUF = 1 << 20;
  uint8_t own_buf[BUF];
  const uint8_t* buf = own_buf;
  size_t pos = 0, len = 0;
  bool eof = false;
  int64_t buf_base = 0;   // absolute file offset of buf[0]
  int64_t end_off = INT64_MAX;  // stop STARTING records at/after this
  bool done = false;      // range exhausted (record-boundary stop)

  // threaded inflate (gz pipelining)
  bool threaded = false;
  static constexpr size_t TBUF = 4 << 20;
  std::thread prod;
  std::mutex mu;
  std::condition_variable cv;
  uint8_t* tbuf[2] = {nullptr, nullptr};
  size_t tlen[2] = {0, 0};
  bool tfull[2] = {false, false};
  bool tdone = false;
  int tcons = 0;   // slot the consumer reads next
  int thold = -1;  // slot the consumer currently points into
  RawGz raw;       // crc-skipping fast path (threaded gz only)
  bool use_raw = false;
  std::atomic<bool> terr{false};  // decode error: surface, don't truncate

  int fmt = 0;  // 0 unknown, 1 fasta, 2 fastq
  // parser state machine
  enum State {
    AT_START,
    IN_HEADER,     // skipping a header line
    IN_SEQ,        // emitting sequence bytes
    IN_QUAL_SEP,   // skipping '+' line (fastq)
    IN_QUAL,       // skipping quality line (fastq)
  } state = AT_START;
  size_t seq_len = 0;   // bases seen in the current record
  size_t qual_len = 0;  // quality bytes still to skip == seq_len
  int trim_left = 0;    // per-file 5' trim
  int trim_remaining = 0;
  bool in_record = false;  // have emitted bases for current record

  // carry-over seam between rows: last (k-1) codes of a split record
  uint8_t seam[256];
  int seam_len = 0;

  ~Reader() {
    if (threaded) {
      {
        std::unique_lock<std::mutex> lk(mu);
        tdone = true;
        tfull[0] = tfull[1] = false;  // unblock a producer waiting on space
      }
      cv.notify_all();
      if (prod.joinable()) prod.join();
      delete[] tbuf[0];
      delete[] tbuf[1];
    }
    if (f) gzclose(f);
  }

  void start_producer() {
    threaded = true;
    tbuf[0] = new uint8_t[TBUF];
    tbuf[1] = new uint8_t[TBUF];
    prod = std::thread([this] {
      int slot = 0;
      for (;;) {
        long n;
        {
          std::unique_lock<std::mutex> lk(mu);
          cv.wait(lk, [&] { return !tfull[slot] || tdone; });
          if (tdone) return;
        }
        n = use_raw ? raw.read(tbuf[slot], TBUF)
                    : static_cast<long>(gzread(f, tbuf[slot], TBUF));
        {
          std::unique_lock<std::mutex> lk(mu);
          if (n <= 0) {
            if (n < 0) terr = true;  // decode error != EOF
            tdone = true;
          } else {
            tlen[slot] = static_cast<size_t>(n);
            tfull[slot] = true;
          }
        }
        cv.notify_all();
        if (n <= 0) return;
        slot ^= 1;
      }
    });
  }

  bool fill() {
    if (pos < len) return true;
    if (eof) return false;
    buf_base += static_cast<int64_t>(len);
    if (threaded) {
      std::unique_lock<std::mutex> lk(mu);
      if (thold >= 0) {
        tfull[thold] = false;  // release the drained slot
        cv.notify_all();
      }
      cv.wait(lk, [&] { return tfull[tcons] || tdone; });
      if (!tfull[tcons]) {
        eof = true;
        thold = -1;
        return false;
      }
      thold = tcons;
      buf = tbuf[tcons];
      len = tlen[tcons];
      pos = 0;
      tcons ^= 1;
      return true;
    }
    int n = gzread(f, const_cast<uint8_t*>(buf), BUF);
    if (n <= 0) {
      if (n < 0) {
        terr = true;  // corrupt stream: error, not clean EOF
      } else {
        // zlib reports a truncated member via gzerror, not a negative
        // return — check before treating a 0-read as clean EOF
        int errnum = Z_OK;
        gzerror(f, &errnum);
        if (errnum != Z_OK && errnum != Z_STREAM_END) terr = true;
      }
      eof = true;
      return false;
    }
    pos = 0;
    len = static_cast<size_t>(n);
    return true;
  }
  int peek() {
    if (done) return -1;
    if (!fill()) return -1;
    return buf[pos];
  }
  int get() {
    if (done) return -1;
    if (!fill()) return -1;
    return buf[pos++];
  }
  // absolute offset of the next unread byte
  int64_t offset() const { return buf_base + static_cast<int64_t>(pos); }
};

// First byte of a gzip stream's DECOMPRESSED content (regular files).
int sniff_fmt_decompressed(const char* path) {
  gzFile f = gzopen(path, "rb");
  if (!f) return 0;
  unsigned char b;
  int n = gzread(f, &b, 1);
  gzclose(f);
  if (n != 1) return 0;
  return (b == '>') ? 1 : (b == '@') ? 2 : 0;
}

// First byte of the file (format sniff), via pread (no stream state).
// Returns 0 for unknown AND for non-REGULAR inputs (FIFOs, /dev/stdin —
// never even opened: an open()+close() on a FIFO can block or disturb
// the writer) — kat_fastx_open falls back to a live-handle peek.
int sniff_fmt(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0 || !S_ISREG(st.st_mode)) return 0;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return 0;
  unsigned char b[2] = {0, 0};
  ssize_t n = pread(fd, b, 2, 0);
  close(fd);
  if (n < 1) return 0;
  if (b[0] == 0x1f && n == 2 && b[1] == 0x8b) return -1;  // gzip
  if (b[0] == '>') return 1;
  if (b[0] == '@') return 2;
  return 0;
}

// Find the first record-header byte at offset >= start in a PLAIN file.
// Returns -1 when none exists before EOF.  FASTQ headers are verified by
// the '+' line two lines down (see file header comment).
int64_t find_record_start(const char* path, int fmt, int64_t start) {
  if (start <= 0) return 0;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  const size_t W = 1 << 16;
  uint8_t win[W];

  auto byte_at = [&](int64_t off) -> int {
    uint8_t b;
    return pread(fd, &b, 1, off) == 1 ? b : -1;
  };
  auto next_nl = [&](int64_t from) -> int64_t {  // offset of next '\n'
    int64_t p = from;
    for (;;) {
      ssize_t n = pread(fd, win, W, p);
      if (n <= 0) return -1;
      const void* hit = memchr(win, '\n', static_cast<size_t>(n));
      if (hit)
        return p + (static_cast<const uint8_t*>(hit) - win);
      p += n;
    }
  };

  int64_t nl = (start == 0) ? -1 : next_nl(start - 1);
  // candidate header = first byte of each line from here on
  while (nl >= 0) {
    int64_t cand = nl + 1;
    int c = byte_at(cand);
    if (c < 0) break;  // EOF
    if (fmt == 1 && c == '>') {
      close(fd);
      return cand;
    }
    if (fmt == 2 && c == '@') {
      int64_t e1 = next_nl(cand);      // end of header line
      int64_t e2 = e1 < 0 ? -1 : next_nl(e1 + 1);  // end of seq line
      if (e2 >= 0 && byte_at(e2 + 1) == '+') {
        close(fd);
        return cand;
      }
    }
    nl = next_nl(cand);
  }
  close(fd);
  return -1;
}

Reader* open_common(const char* path, int trim5, int fmt, int64_t seek_to,
                    int64_t end_off, bool threaded) {
  Reader* r = new Reader();
  r->trim_left = trim5;
  r->fmt = fmt;
  r->buf_base = seek_to;
  r->end_off = end_off;
  if (threaded && seek_to == 0 && r->raw.open(path)) {
    r->use_raw = true;  // crc-skipping raw-deflate fast path
    r->start_producer();
    return r;
  }
  gzFile f = gzopen(path, "rb");
  if (!f) {
    delete r;
    return nullptr;
  }
  gzbuffer(f, 1 << 20);
  if (seek_to > 0 && gzseek(f, static_cast<z_off_t>(seek_to),
                            SEEK_SET) < 0) {
    gzclose(f);
    r->f = nullptr;
    delete r;
    return nullptr;
  }
  r->f = f;
  if (threaded) r->start_producer();
  return r;
}

}  // namespace

extern "C" {

// 1 = plain FASTA, 2 = plain FASTQ, -1 = gzip, 0 = unknown/unreadable.
int kat_fastx_sniff(const char* path) { return sniff_fmt(path); }

void* kat_fastx_open(const char* path, int trim5) {
  int fmt = sniff_fmt(path);
  if (fmt == -1) fmt = sniff_fmt_decompressed(path);
  if (fmt > 0) return open_common(path, trim5, fmt, 0, INT64_MAX, false);
  // Non-seekable input (FIFO, /dev/stdin, process substitution) or
  // unreadable: sniff on the LIVE handle so no byte is lost (the
  // original C ABI accepted pipes; pread cannot).
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  gzbuffer(f, 1 << 20);
  Reader* r = new Reader();
  r->f = f;
  r->trim_left = trim5;
  int c = r->peek();
  if (c == '>') {
    r->fmt = 1;
  } else if (c == '@') {
    r->fmt = 2;
  } else {
    delete r;
    return nullptr;
  }
  return r;
}

// Reader over the records whose header byte lies in [start, end) of a
// PLAIN (uncompressed) file.  Returns nullptr for compressed/unknown
// files.  A range holding no record start yields an immediately-EOF
// reader (next_codes returns 0).
void* kat_fastx_open_range(const char* path, int trim5, int64_t start,
                           int64_t end) {
  int fmt = sniff_fmt(path);
  if (fmt <= 0) return nullptr;  // gz or unknown: ranges unsupported
  int64_t s = find_record_start(path, fmt, start);
  Reader* r;
  if (s < 0 || s >= end) {
    r = open_common(path, trim5, fmt, 0, end, false);
    if (r) r->done = true;  // empty range
  } else {
    r = open_common(path, trim5, fmt, s, end, false);
  }
  return r;
}

// Whole-file reader whose gzip inflate runs on a dedicated producer
// thread (double-buffered) — parse overlaps decompression.
void* kat_fastx_open_threaded(const char* path, int trim5) {
  int fmt = sniff_fmt(path);
  if (fmt == -1) fmt = sniff_fmt_decompressed(path);
  if (fmt <= 0) return nullptr;  // pipes take the kat_fastx_open path
  return open_common(path, trim5, fmt, 0, INT64_MAX, true);
}

void kat_fastx_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  delete r;
}

// Fill out[rows * row_len] with 2-bit codes, densely packed as described in
// the file header.  Returns the number of rows that contain at least one
// potential k-window (0 at EOF).  k must be < 256 and <= row_len.
int64_t kat_fastx_next_codes(void* h, int k, int64_t rows, int64_t row_len,
                             uint8_t* out) {
  Reader* r = static_cast<Reader*>(h);
  if (!r || k < 1 || k > 255 || row_len < k) return -1;

  int64_t row = 0;
  while (row < rows) {
    uint8_t* dst = out + row * row_len;
    int64_t col = 0;

    // Re-emit the seam from the previous row (same record continues).
    for (int i = 0; i < r->seam_len; ++i) dst[col++] = r->seam[i];
    r->seam_len = 0;

    while (col < row_len) {
      int c = r->get();
      if (c < 0) break;  // EOF or range exhausted
      switch (r->state) {
        case Reader::AT_START:
          // c is '>' or '@' (validated at open)
          r->state = Reader::IN_HEADER;
          r->in_record = false;
          r->seq_len = 0;
          r->trim_remaining = r->trim_left;
          break;
        case Reader::IN_HEADER:
          if (c == '\n') r->state = Reader::IN_SEQ;
          break;
        case Reader::IN_SEQ:
          if (c == '\n') {
            if (r->fmt == 2) {
              // FASTQ: single sequence line, then '+'
              r->state = Reader::IN_QUAL_SEP;
            }
            // FASTA: stay IN_SEQ (multi-line); header char handled below
          } else if (r->fmt == 1 && c == '>' && r->in_record == false &&
                     r->seq_len == 0) {
            // empty record, new header
            if (r->offset() - 1 >= r->end_off) {
              r->done = true;
              break;
            }
            r->state = Reader::IN_HEADER;
          } else if (r->fmt == 1 && c == '>') {
            // new FASTA record: separate.  Its header byte is the one
            // just consumed — if it lies at/after end_off it belongs to
            // the next range reader.
            if (r->offset() - 1 >= r->end_off) {
              r->done = true;
              break;
            }
            if (r->in_record && col < row_len) dst[col++] = INVALID;
            r->state = Reader::IN_HEADER;
            r->in_record = false;
            r->seq_len = 0;
            r->trim_remaining = r->trim_left;
          } else if (c != '\r') {
            if (r->trim_remaining > 0) {
              --r->trim_remaining;
              ++r->seq_len;
            } else {
              dst[col++] = kLut.lut[c];
              r->in_record = true;
              ++r->seq_len;
            }
          }
          break;
        case Reader::IN_QUAL_SEP:
          if (c == '\n') {
            r->state = Reader::IN_QUAL;
            r->qual_len = r->seq_len;
          }
          break;
        case Reader::IN_QUAL:
          if (c == '\n') {
            // next record (or EOF); its header byte is the next unread
            // byte — stop here if it falls outside this reader's range
            if (r->offset() >= r->end_off) {
              r->done = true;
              if (r->in_record && col < row_len) dst[col++] = INVALID;
              break;
            }
            if (r->in_record && col < row_len) dst[col++] = INVALID;
            r->state = Reader::IN_HEADER;  // '@' header comes next; its
                                           // first char is part of header
            r->in_record = false;
            r->seq_len = 0;
            r->trim_remaining = r->trim_left;
            // skip the '@' of the next header (may hit EOF)
            // handled naturally: IN_HEADER skips until newline
          }
          break;
      }
      if (r->done) break;
    }

    if (r->terr) return -1;  // producer decode error: fail, not truncate
    if (col == 0) break;  // EOF and nothing emitted

    if (col >= row_len) {
      // Row full: if mid-record, save the (k-1)-code seam for the next row.
      if (r->state == Reader::IN_SEQ && r->in_record) {
        int s = k - 1;
        for (int i = 0; i < s; ++i) r->seam[i] = dst[row_len - s + i];
        r->seam_len = s;
      }
    } else {
      // EOF inside this row: pad.
      for (; col < row_len; ++col) dst[col] = PAD;
    }
    ++row;
    if (r->done) break;
    if (r->eof && r->pos >= r->len && r->seam_len == 0) break;
  }
  return row;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Minimizer supermer router (the host half of the bucketed counting flush,
// see kat_tpu/core/minimizer.py).  Parses FASTX through the same Reader
// machinery, computes canonical minimizers per k-window with a rolling
// m-mer pair + small ring-buffer sliding minimum, splits reads into
// supermer records (consecutive windows sharing a minimizer, <= S per
// record, S = rec_windows(k)), and bins records by the top `bucket_bits`
// of mix26(minimizer).  kat_smr_next_flush packs whole buckets, in
// ascending bucket id, into a fixed [n_chunks x rec_per_chunk] u64 chunk
// layout; buckets larger than one chunk get an ALIGNED power-of-two group
// of dedicated chunks (reported so the device can run the group-merge
// phases); leftover buckets carry over to the next flush.
//
// Record format (must match core/minimizer.py rec_windows/expand_records):
//   u64 = [ len (3 bits, 63..61) | bases (2*(k-1+S) bits, left-aligned:
//   first base at bit 2*(k-1+S)-2..) ]; len = 0 is a padding record.
//
// This replaces nothing in the reference (jellyfish hashes unsorted);
// it is the KMC2 signature-bin idea (PAPERS.md) applied so the device
// sort runs per chunk instead of globally.
// ---------------------------------------------------------------------------

namespace {

constexpr uint32_t SMR_M26 = (1u << 26) - 1;
constexpr uint32_t SMR_MIX_A = 41474379u;  // must match core/minimizer.py
constexpr uint32_t SMR_MIX_B = 56006713u;

inline uint32_t smr_mix26(uint32_t x) {
  x ^= x >> 13;
  x = (x * SMR_MIX_A) & SMR_M26;
  x ^= x >> 13;
  x = (x * SMR_MIX_B) & SMR_M26;
  x ^= x >> 13;
  return x;
}

struct Smr {
  Reader* rd = nullptr;
  int k = 0, m = 0, bucket_bits = 0, S = 0;
  uint32_t n_buckets = 0;

  // parse buffer
  static constexpr int64_t ROWS = 16;
  static constexpr int64_t ROW_LEN = 1 << 16;
  std::vector<uint8_t> rowbuf;
  int64_t rows_have = 0, row_i = 0, col_i = 0;
  bool parse_eof = false;

  // bins, behind a software write-combining stage: records scatter to
  // random buckets (one every ~3 windows), and a direct
  // bins[b].push_back per record cache-misses across thousands of
  // vector tails.  Staging 32 records per bucket in one contiguous
  // L2-resident array amortizes that miss 32x (the standard KMC bin
  // trick).
  static constexpr int STG = 32;
  std::vector<std::vector<uint64_t>> bins;
  std::vector<int64_t> bin_windows;
  std::vector<uint64_t> stg;   // [n_buckets * STG]
  std::vector<uint8_t> stg_n;  // per-bucket staged count
  int64_t binned_records = 0;
  int64_t emitted_windows = 0;

  ~Smr() { delete rd; }

  void flush_bucket(uint32_t b) {
    uint8_t n = stg_n[b];
    if (!n) return;
    const uint64_t* s = &stg[static_cast<size_t>(b) * STG];
    bins[b].insert(bins[b].end(), s, s + n);
    int64_t w = 0;
    for (uint8_t i = 0; i < n; ++i) w += static_cast<int64_t>(s[i] >> 61);
    bin_windows[b] += w;
    stg_n[b] = 0;
  }

  void flush_all_buckets() {
    for (uint32_t b = 0; b < n_buckets; ++b) flush_bucket(b);
  }

  // Process one code row.  ALL rolling state is row-local (rows
  // re-establish context through the reader's (k-1) seam, so supermer
  // runs may split at row boundaries — correctness is unaffected, and
  // keeping the state in registers instead of struct fields is what
  // makes the scan run at memory speed).
  void feed_row(const uint8_t* row, int64_t n) {
    const int kk = k, mm = m, SS = S;
    const int F = 2 * (kk - 1 + SS);
    const int rc_sh = 2 * (mm - 1);
    const int bsh = 26 - bucket_bits;
    uint32_t fwd_m = 0, rc_m = 0;
    int64_t valid_run = 0;
    uint32_t ring[32];
    uint8_t hist[64];
    int64_t min_at = -1;
    uint32_t min_val = 0;
    int run_len = 0;
    uint32_t run_val = 0;
    uint64_t run_bases = 0;
    int64_t n_recs = 0, n_wins = 0;

    uint64_t* stg_base = stg.data();
    uint8_t* stgn_base = stg_n.data();
    auto close_run = [&]() {
      if (run_len > 0) {
        uint64_t rec = run_bases << (F - 2 * (kk - 1 + run_len));
        rec |= static_cast<uint64_t>(run_len) << 61;
        uint32_t b = smr_mix26(run_val) >> bsh;
        uint8_t& sn = stgn_base[b];
        stg_base[static_cast<size_t>(b) * STG + sn] = rec;
        if (++sn == STG) flush_bucket(b);
        ++n_recs;
        n_wins += run_len;
      }
      run_len = 0;
    };

    for (int64_t i = 0; i < n; ++i) {
      uint8_t c = row[i];
      if (c >= 4) {
        close_run();
        valid_run = 0;
        min_at = -1;
        continue;
      }
      fwd_m = ((fwd_m << 2) | c) & SMR_M26;
      rc_m = (rc_m >> 2) | ((3u - c) << rc_sh);
      hist[i & 63] = c;
      ++valid_run;
      if (valid_run < mm) continue;
      uint32_t cm = fwd_m < rc_m ? fwd_m : rc_m;
      ring[i & 31] = cm;
      // sliding min over m-mer end positions [i-(k-m), i]
      if (min_at >= 0 && min_at < i - (kk - mm)) {
        // expired: rescan (<= 17 values; ascending q + strict < keeps
        // the leftmost tie).  Slots from before this valid streak are
        // stale: fresh only when q >= i - valid_run + m.
        min_at = -1;
        int64_t q0 = i - (kk - mm);
        int64_t fresh = i - valid_run + mm;
        if (q0 < fresh) q0 = fresh;
        for (int64_t q = q0; q <= i; ++q) {
          uint32_t v = ring[q & 31];
          if (min_at < 0 || v < min_val) {
            min_val = v;
            min_at = q;
          }
        }
      }
      if (min_at < 0 || cm < min_val) {
        min_val = cm;
        min_at = i;
      }
      if (valid_run < kk) continue;
      if (run_len > 0 && run_val == min_val && run_len < SS) {
        ++run_len;
        run_bases = (run_bases << 2) | c;
      } else {
        close_run();
        run_val = min_val;
        run_len = 1;
        run_bases = 0;
        for (int j = kk - 1; j >= 0; --j)
          run_bases = (run_bases << 2) | hist[(i - j) & 63];
      }
    }
    close_run();
    binned_records += n_recs;
    emitted_windows += n_wins;
  }

  // Parse more input into bins.  Returns false at EOF with nothing fed.
  bool parse_some() {
    if (parse_eof) return false;
    if (row_i >= rows_have) {
      rows_have = kat_fastx_next_codes(rd, k, ROWS, ROW_LEN,
                                       rowbuf.data());
      row_i = 0;
      col_i = 0;
      if (rows_have <= 0) {
        parse_eof = true;
        return false;
      }
    }
    // one row per call keeps the caller's pacing granular
    feed_row(rowbuf.data() + row_i * ROW_LEN, ROW_LEN);
    ++row_i;
    return true;
  }
};

}  // namespace

extern "C" {

static void* smr_open_common(void* rd, int k, int m, int bucket_bits) {
  if (!rd) return nullptr;
  // largest POW2 S with 2*(k-1+S)+3 <= 64 (must match
  // core/minimizer.py rec_windows: pow2 keeps chunk_slots pow2)
  int S = (64 - 3) / 2 - (k - 1);
  S = S >= 4 ? 4 : (S >= 2 ? 2 : 1);
  if (k <= m || k > m + 16 || m < 3 || m > 15 || (m % 2) == 0 ||
      S < 1 || bucket_bits < 1 || bucket_bits > 16) {
    kat_fastx_close(rd);
    return nullptr;
  }
  Smr* s = new Smr();
  s->rd = static_cast<Reader*>(rd);
  s->k = k;
  s->m = m;
  s->S = S;
  s->bucket_bits = bucket_bits;
  s->n_buckets = 1u << bucket_bits;
  s->bins.resize(s->n_buckets);
  s->bin_windows.assign(s->n_buckets, 0);
  s->stg.resize(static_cast<size_t>(s->n_buckets) * Smr::STG);
  s->stg_n.assign(s->n_buckets, 0);
  s->rowbuf.resize(Smr::ROWS * Smr::ROW_LEN);
  return s;
}

void* kat_smr_open(const char* path, int k, int m, int bucket_bits,
                   int trim5) {
  return smr_open_common(kat_fastx_open(path, trim5), k, m, bucket_bits);
}

// Range variant: routes only the records whose header byte lies in
// [start, end) of a PLAIN file (kat_fastx_open_range semantics) — the
// byte-level split that lets N independent routers share one file; each
// router's flushes merge through the count table like any other flush.
void* kat_smr_open_range(const char* path, int k, int m, int bucket_bits,
                         int trim5, int64_t start, int64_t end) {
  return smr_open_common(kat_fastx_open_range(path, trim5, start, end),
                         k, m, bucket_bits);
}

void kat_smr_close(void* h) { delete static_cast<Smr*>(h); }

// Attach ANOTHER input (whole file, or a byte range of a plain file) to
// an existing router, KEEPING its bucket bins.  This is how one worker
// routes many byte ranges without emitting a partial tail flush per
// range: bins accumulate across inputs and kat_smr_next_flush with
// finalize=0 refuses to pack under-target remainders.
// Returns 1 ok, 0 failure (router unchanged).
int kat_smr_attach(void* h, const char* path, int trim5, int64_t start,
                   int64_t end) {
  Smr* s = static_cast<Smr*>(h);
  if (!s) return 0;
  void* rd = (start == 0 && end >= (int64_t{1} << 62))
                 ? kat_fastx_open(path, trim5)
                 : kat_fastx_open_range(path, trim5, start, end);
  if (!rd) return 0;
  delete s->rd;
  s->rd = static_cast<Reader*>(rd);
  s->parse_eof = false;
  s->rows_have = 0;
  s->row_i = 0;
  return 1;
}

// Pack up to max_chunks chunks of rec_per_chunk u64 records.
//   chunks_out: [max_chunks * rec_per_chunk] u64, caller-allocated; padding
//     records are written as 0.
//   groups_out: [2 * max_groups] int32 (start_chunk, log2_size) pairs for
//     hot buckets spanning >1 chunk (device must merge those chunk runs).
//   stats_out:  [0]=n_windows packed, [1]=n_records packed, [2]=n_groups.
//   finalize: 0 = if the CURRENT input is exhausted with bins below the
//     flush target, return 0 WITHOUT packing (so the caller can
//     kat_smr_attach more input and keep accumulating full flushes);
//     1 = pack whatever remains (end of all inputs).
// Returns the number of chunks filled; 0 when more input is needed
// (finalize=0) or everything is drained (finalize=1).  -1 on reader
// error.
int64_t kat_smr_next_flush2(void* h, int64_t max_chunks,
                            int64_t rec_per_chunk, uint64_t* chunks_out,
                            int32_t* groups_out, int64_t max_groups,
                            int64_t* stats_out, int finalize) {
  Smr* s = static_cast<Smr*>(h);
  if (!s || max_chunks < 1 || rec_per_chunk < 1) return -1;
  // accumulate a little past the chunk budget so packing can FILL it;
  // whatever does not fit carries over to the next flush
  int64_t target = max_chunks * rec_per_chunk * 21 / 20;
  while (s->binned_records < target) {
    if (!s->parse_some()) break;
    if (s->rd->terr) return -1;
  }
  if (!finalize && s->parse_eof && s->binned_records < target) {
    s->flush_all_buckets();
    return 0;  // caller should attach more input (bins kept)
  }
  s->flush_all_buckets();  // staged records land before packing
  if (s->binned_records == 0) return 0;

  std::memset(chunks_out, 0,
              sizeof(uint64_t) * max_chunks * rec_per_chunk);
  int64_t chunk = 0;    // next chunk with free space
  int64_t used = 0;     // records used in `chunk`
  int64_t n_groups = 0;
  int64_t packed_windows = 0, packed_records = 0;
  // PROPORTIONAL take: every bucket contributes ~its share of the chunk
  // budget each flush.  (The original greedy pack consumed buckets in
  // ascending id until chunks ran out, which STARVED high-id buckets —
  // they accumulated for the entire run and came out at EOF as more hot
  // groups than the report array holds, a silent ordering-correctness
  // bug caught by the 2048-chunk chip A/B's parity check.)  Splitting a
  // bucket across flushes is always safe: counts merge through the
  // table; only the WITHIN-flush ascending-bucket order matters.
  int64_t cap_rec = max_chunks * rec_per_chunk;
  double scale = s->binned_records > cap_rec * 49 / 50
                     ? static_cast<double>(cap_rec * 49 / 50) /
                           static_cast<double>(s->binned_records)
                     : 1.0;
  for (uint32_t b = 0; b < s->n_buckets; ++b) {
    std::vector<uint64_t>& bin = s->bins[b];
    if (bin.empty()) continue;
    int64_t need = static_cast<int64_t>(bin.size());
    int64_t want = scale < 1.0
                       ? static_cast<int64_t>(need * scale) + 1
                       : need;
    if (want > need) want = need;
    if (want <= rec_per_chunk) {
      if (used + want > rec_per_chunk) {  // start a fresh chunk
        ++chunk;
        used = 0;
      }
      if (chunk >= max_chunks) break;
      std::memcpy(chunks_out + chunk * rec_per_chunk + used,
                  bin.data() + (need - want), sizeof(uint64_t) * want);
      used += want;
      packed_records += want;
      if (want == need) {
        packed_windows += s->bin_windows[b];
        s->bin_windows[b] = 0;
        bin.clear();
        bin.shrink_to_fit();
      } else {
        int64_t wtaken = 0;
        for (int64_t i = need - want; i < need; ++i)
          wtaken += static_cast<int64_t>(bin[i] >> 61);
        bin.resize(need - want);
        s->bin_windows[b] -= wtaken;
        packed_windows += wtaken;
      }
      continue;
    }
    // hot bucket: dedicated ALIGNED pow2 group of chunks.  NEVER place
    // an unreported group (the device must know to merge its chunk
    // runs): if the report array is full, defer the bucket instead.
    if (n_groups >= max_groups) continue;
    int64_t g = 1;
    while (g * rec_per_chunk < want && g < max_chunks) g <<= 1;
    if (used > 0) {  // current chunk is partially filled: close it
      ++chunk;
      used = 0;
    }
    int64_t start = ((chunk + g - 1) / g) * g;  // align to group size
    while (g > 1 && start + g > max_chunks) {
      g >>= 1;  // emit only part of the bucket this flush
      start = ((chunk + g - 1) / g) * g;
    }
    if (start + g > max_chunks) break;  // no room at all: defer bucket
    int64_t take = want < g * rec_per_chunk ? want : g * rec_per_chunk;
    std::memcpy(chunks_out + start * rec_per_chunk,
                bin.data() + (need - take), sizeof(uint64_t) * take);
    // window accounting: recompute from the records taken
    int64_t wtaken = 0;
    for (int64_t i = need - take; i < need; ++i)
      wtaken += static_cast<int64_t>(bin[i] >> 61);
    bin.resize(need - take);
    s->bin_windows[b] -= wtaken;
    packed_records += take;
    packed_windows += wtaken;
    if (g > 1) {
      groups_out[2 * n_groups] = static_cast<int32_t>(start);
      groups_out[2 * n_groups + 1] = static_cast<int32_t>(
          __builtin_ctzll(static_cast<unsigned long long>(g)));
      ++n_groups;
    }
    chunk = start + g;
    used = 0;
  }
  s->binned_records -= packed_records;
  stats_out[0] = packed_windows;
  stats_out[1] = packed_records;
  stats_out[2] = n_groups;
  int64_t n_chunks = chunk + (used > 0 ? 1 : 0);
  return n_chunks;
}

// Original single-input entry point: always pack remainders.
int64_t kat_smr_next_flush(void* h, int64_t max_chunks,
                           int64_t rec_per_chunk, uint64_t* chunks_out,
                           int32_t* groups_out, int64_t max_groups,
                           int64_t* stats_out) {
  return kat_smr_next_flush2(h, max_chunks, rec_per_chunk, chunks_out,
                             groups_out, max_groups, stats_out, 1);
}

}  // extern "C"
