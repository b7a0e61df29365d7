// banded_dp: sublong's between-anchor banded alignment, every segment of a
// chunk in one launch: the fill of each segment's band and its backtrack,
// giving the run-length operations that align.longread.banded_align gives,
// op for op.
//
// It replaces no TPU kernel.  The JAX package refines these segments on the
// host with numpy (subread_tpu/align/longread.py::banded_align, a Python
// loop over the rows with a second one over each row's deletion run); the
// port ran that copy too until this kernel took the work to the card.
//
// What bounds it on the card: not bytes but the serial chain of rows.  A
// segment's rows depend each on the one before, so the launch lasts at
// least as long as its longest segment's rows take one after another (at
// most max_refine + 100 = 4,100 rows in sublong), each row a few loads from
// shared memory, a min-scan across the team and a store.  Its bytes are the
// traceback table, one byte a band cell written once and about n + m of
// them read back, plus the stretches and the runs: at 3.35 TB/s they take
// microseconds.  Segments run side by side, so a chunk's ~2,000 segments
// cost about the longest one's chain.
//
// Layout and design (the Python wrapper ops/banded_dp.py packs the input):
//   * the segment table, int64 [S, 7]: read offset, genome offset, n, m,
//     band = |n - m| + extra, the segment's first traceback cell, its slot;
//     its first n_wide rows are the segments whose band row can be wider
//     than a warp covers, the rest are narrow;
//   * a narrow segment gets one warp (32 lanes x 8 cells = 256 columns),
//     sixteen to a block; a wide one gets a whole block (512 threads x 16
//     cells = 8,192 columns).  The shape chooses: a band row spans at most
//     min(m, 2 band + 1) columns;
//   * row i keeps the columns max(1, i - band)..min(m, i + band) only, in
//     shared memory, two rows a team (the previous one and this one); a
//     thread owns 8 or 16 neighbouring cells;
//   * within a row, diagonal and up are elementwise; the deletion run
//     run[k] = min(best[k], run[k-1] + 1) is k plus the exclusive prefix-min
//     of best[k] - k, from each thread's own cells and one scan across the
//     team (warp shuffles, then the warps' totals through shared memory for
//     a block): exact in integers.  LEFT is taken only where strictly
//     better, and never at the band's first column; DIAG wins its ties with
//     UP; column 0 holds i while i - 1 <= band; outside the band lies
//     BIG = 2^20 — banded_align's rules, bit for bit;
//   * each cell's operation (0 DIAG, 1 UP, 2 LEFT) goes to the traceback
//     table in device memory, one byte, at the segment's cell offset plus
//     the cells of the rows before;
//   * after the last row, one thread of the team walks back from (n, m) by
//     banded_align's rule (DIAG -> M; else UP or column 0 -> I; else D),
//     merges equal neighbours into runs and writes them, (length << 2) | op,
//     backwards from the end of the segment's slot, then the run count.
// The wrapper allocates the table and the output; the kernel allocates
// nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;     // a block; a wide segment's team
constexpr int kWarpCells = 8;     // cells a lane of a narrow team owns
constexpr int kBlockCells = 16;   // cells a thread of a wide team owns
constexpr int kTeams = kThreads / 32;
constexpr int kNarrow = 32 * kWarpCells;
constexpr int kWide = kThreads * kBlockCells;
constexpr int kSmem = 2 * kWide * 4;   // two rows of a wide team; 16 narrow teams fit too
constexpr int kBig = 1 << 20;
constexpr int kInf = 0x3fffffff;
constexpr int kCols = 7;

static_assert(kTeams * 2 * kNarrow <= 2 * kWide, "narrow teams' rows must fit");

struct Seg {
  const uint8_t* rd;
  const uint8_t* gn;
  int n, m, band;
  long long cell;
  int* slot_end;
};

__device__ __forceinline__ Seg load_seg(const long long* table, int k,
                                        const uint8_t* reads, const uint8_t* gens,
                                        int* out, int S) {
  const long long* r = table + (long long)k * kCols;
  Seg s;
  s.rd = reads + r[0];
  s.gn = gens + r[1];
  s.n = (int)r[2];
  s.m = (int)r[3];
  s.band = (int)r[4];
  s.cell = r[5];
  s.slot_end = out + S + r[6] + r[2] + r[3];
  return s;
}

template <int T>
__device__ __forceinline__ void team_sync() {
  if (T == 32) __syncwarp(); else __syncthreads();
}

// Exclusive min-scan of v over the team's threads, in thread order.
template <int T>
__device__ __forceinline__ int team_excl_min(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc = min(inc, o);
  }
  int ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = kInf;
  if (T == 32) return ex;
  const int warp = threadIdx.x >> 5;
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  int before = kInf;
  for (int w = 0; w < warp; ++w) before = min(before, scratch[w]);
  return min(before, ex);
}

// One segment by a team of T threads, C cells each: fill, then backtrack.
template <int T, int C>
__device__ void refine_segment(const Seg& s, int tid, int* prev, int* cur,
                               int* scratch, uint8_t* tbl, int* count) {
  const int n = s.n, m = s.m, band = s.band;
  if (min(m, 2 * band + 1) > T * C) {   // the team cannot hold the band
    if (tid == 0) *count = -1;
    return;
  }
  int lo_p = 0, w_p = 0;
  long long rowoff = 0;                 // cells of the rows before row i
  const int t0 = tid * C;
  for (int i = 1; m > 0 && i <= n; ++i) {
    const int lo = max(1, i - band);
    const int w = min(m, i + band) - lo + 1;
    const int rb = s.rd[i - 1];
    // row i - 1's value at column col
    auto pv = [&](int col) -> int {
      if (i == 1) return col;
      if (col == 0) return i - 2 <= band ? i - 1 : kBig;
      const int idx = col - lo_p;
      return (idx >= 0 && idx < w_p) ? prev[idx] : kBig;
    };
    int x[C];
    unsigned bits = 0;
    int agg = kInf;
    int diag = t0 < w ? pv(lo + t0 - 1) : 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = t0 + c;
      x[c] = kInf;
      if (t < w) {
        const int j = lo + t;
        const int up = pv(j);
        const int sub = diag + (s.gn[j - 1] != rb);
        const int upv = up + 1;
        bits |= (sub <= upv ? 0u : 1u) << (2 * c);
        x[c] = min(sub, upv) - t;
        agg = min(agg, x[c]);
        diag = up;
      }
    }
    int run = team_excl_min<T>(agg, scratch);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = t0 + c;
      if (t < w) {
        const int best = x[c] + t;
        unsigned op = (bits >> (2 * c)) & 3u;
        int val = best;
        if (run + t < best) {   // LEFT, strictly better; run is kInf at column lo
          val = run + t;
          op = 2;
        }
        cur[t] = val;
        tbl[s.cell + rowoff + t] = (uint8_t)op;
        run = min(run, x[c]);
      }
    }
    team_sync<T>();
    int* tmp = prev;
    prev = cur;
    cur = tmp;
    lo_p = lo;
    w_p = w;
    rowoff += w;
  }
  if (tid != 0) return;
  // backtrack from (n, m); off is the cells of the rows before row i
  int i = n, j = m, cnt = 0, op = -1, len = 0;
  int* out = s.slot_end;
  long long off = rowoff;
  if (m > 0 && n > 0) off -= min(m, n + band) - max(1, n - band) + 1;
  while (i > 0 || j > 0) {
    int o;
    if (i == 0) o = 2;
    else if (j == 0) o = 1;
    else o = tbl[s.cell + off + (j - max(1, i - band))];
    if (o == op) {
      ++len;
    } else {
      if (len) { *--out = (len << 2) | op; ++cnt; }
      op = o;
      len = 1;
    }
    if (o != 2) {
      --i;
      if (i > 0 && m > 0) off -= min(m, i + band) - max(1, i - band) + 1;
    }
    if (o != 1) --j;
  }
  if (len) { *--out = (len << 2) | op; ++cnt; }
  *count = cnt;
}

__global__ void __launch_bounds__(kThreads) banded_dp_kernel(
    const long long* __restrict__ table, int S, int n_wide,
    const uint8_t* __restrict__ reads, const uint8_t* __restrict__ gens,
    uint8_t* __restrict__ tbl, int* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ int scratch[kTeams];
  const int b = blockIdx.x;
  if (b < n_wide) {
    const Seg s = load_seg(table, b, reads, gens, out, S);
    refine_segment<kThreads, kBlockCells>(s, threadIdx.x, smem, smem + kWide,
                                          scratch, tbl, out + b);
    return;
  }
  // sixteen narrow segments, a warp each; no block-wide barrier below
  const int team = threadIdx.x >> 5;
  const int k = n_wide + (b - n_wide) * kTeams + team;
  if (k >= S) return;
  const Seg s = load_seg(table, k, reads, gens, out, S);
  int* rows = smem + team * 2 * kNarrow;
  refine_segment<32, kWarpCells>(s, threadIdx.x & 31, rows, rows + kNarrow,
                                 scratch, tbl, out + k);
}

}  // namespace

// table: int64 [S, 7] on the device; reads, gens: the packed stretches;
// tbl: scratch of the batch's band cells (bytes); out: int32 [S + slots].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int banded_dp_launch(const long long* table, int S, int n_wide,
                                const uint8_t* reads, const uint8_t* gens,
                                uint8_t* tbl, int* out, cudaStream_t stream) {
  if (S <= 0) return 0;
  cudaFuncSetAttribute(banded_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmem);
  const int blocks = n_wide + (S - n_wide + kTeams - 1) / kTeams;
  banded_dp_kernel<<<blocks, kThreads, kSmem, stream>>>(table, S, n_wide, reads,
                                                       gens, tbl, out);
  return (int)cudaGetLastError();
}
