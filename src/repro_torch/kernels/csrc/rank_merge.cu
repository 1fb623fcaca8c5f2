// Merge-rank counts for sorted index streams (Hopper, sm_90a): a merge path.
//
// Replaces the TPU kernel `rank_counts(banded=False)` of
// src/repro/kernels/rank_merge.py (Pallas body `_kernel`): counts[i] =
// #{j : b_j < a_i} (strict) or <= (non-strict) over two sorted streams
// padded with SENTINEL = 0xFFFFFFFF, compared in unsigned 32-bit order,
// over all of b, SENTINEL pads included.
//
// What bounds it on the card: bytes.  The TPU version is a dense Ca x Cb
// compare plane; a binary search per query (this file's first design)
// made every query a chain of dependent loads whose deep levels fetch one
// 32-byte sector for 8 useful bytes.  Both ignore that the queries are
// sorted too.  The counts are the positions of a's entries in the merge
// of a and b, so the kernel merges (Green, McColl & Bader, "GPU Merge
// Path", 2012):
//
// * partition: one thread per output tile of TILE entries finds the tile's
//   co-rank -- how many of its first entries come from a -- by a binary
//   search over the diagonal, all tiles at once, into a splitter array;
// * merge: a block loads its tile's slices of a and b into shared memory
//   with coalesced loads, each thread finds its own sub-diagonal there by
//   the same search and merges ITEMS outputs serially; an entry a_i
//   merged at position d has count d - i.
//
// Ties: strict puts a before b (a_i counts only smaller b), non-strict b
// before a.  Every entry is read once and written once per merge.
//
// Mode 2 (the k-way merge of one butterfly layer in one call) runs a
// merge tree of ceil(log2 k) levels of the same two-way merge per group.
// Level 0 reads the int64 runs and packs each entry as the uint64 key
// (value << 32) | origin, origin = r * cap + i (its flat index in the
// group); keys are then distinct and their order is (value, run,
// position), the stable order of repro.kernels.ops.merge_sorted_runs
// (earlier runs win ties).  Level l merges adjacent segments of 2^l runs
// pairwise (an odd one is copied through) into a uint64 ping-pong buffer;
// the last level writes out[origin] = merged position, the merge rank.
// A group whose keys fit twice in a block's shared memory (k * cap * 16
// bytes) runs the whole tree there instead, one block per group, in one
// launch and without scratch: at small layers the partition and merge
// launches of every level cost more than their work.  Otherwise the
// wrapper allocates the splitters and buffers (`repro_rank_counts_scratch`
// bytes); the kernels allocate nothing.
// Results are integers, written once each: exact and the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 256 threads x 4 outputs beat 8 and 2 outputs, and 128 or 512 threads,
// at both union_wire layers on the card (tools/rank_sweep.py, PERF.md)
constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;  // merged outputs per block

// What one merge reads and writes.  TWO (modes 0/1): row g of a against
// row g of b, counts of a's entries.  TREE (mode 2): one level of the
// merge tree over the group's n = k * cap entries.
enum Kind { TWO = 0, TREE = 1 };

struct Level {
  const int64_t* a;         // TWO: a rows [groups, na]; TREE level 0: runs
  const int64_t* b;         // TWO: b rows [groups, nb]
  const uint64_t* keys_in;  // TREE levels > 0: [groups, n]
  uint64_t* keys_out;       // TREE, all levels but the last: [groups, n]
  int32_t* out;             // TWO: counts [groups, na]; TREE: ranks
  int32_t* split;           // co-ranks [groups, pairs, tiles + 1]
  int64_t na, nb;           // TWO: row lengths
  int64_t n, seg;           // TREE: entries per group, per input segment
  int pairs, tiles;         // merges per group, output tiles per merge
  bool a_wins_ties;         // TWO: strict; TREE: keys are distinct
};

struct Pair {
  int64_t a0, la, b0, lb;  // A = [a0, a0 + la), B = [b0, b0 + lb)
};

template <int KIND>
__device__ __forceinline__ Pair pair_of(const Level& L, int p) {
  if (KIND == TWO) return {0, L.na, 0, L.nb};
  const int64_t a0 = 2 * (int64_t)p * L.seg;
  const int64_t a1 = a0 + L.seg < L.n ? a0 + L.seg : L.n;
  const int64_t b1 = a1 + L.seg < L.n ? a1 + L.seg : L.n;
  return {a0, a1 - a0, a1, b1 - a1};
}

// Key of entry `pos` of group g (of b's row when `from_b`, TWO only).
template <int KIND, bool FIRST>
__device__ __forceinline__ uint64_t load_key(const Level& L, int64_t g,
                                             bool from_b, int64_t pos) {
  if (KIND == TWO) {
    return from_b ? (uint32_t)__ldg(L.b + g * L.nb + pos)
                  : (uint32_t)__ldg(L.a + g * L.na + pos);
  } else if (FIRST) {
    return ((uint64_t)(uint32_t)__ldg(L.a + g * L.n + pos) << 32) |
           (uint64_t)pos;
  } else {
    return L.keys_in[g * L.n + pos];
  }
}

__device__ __forceinline__ bool a_first(uint64_t x, uint64_t y, bool ties) {
  return ties ? x <= y : x < y;
}

// Co-rank of diagonal d: the number of A's entries among the first d of
// the merge of A (la entries) and B (lb), i.e. the least i in
// [max(0, d - lb), min(d, la)] whose A[i] does not come before B[d-1-i].
template <typename FA, typename FB>
__device__ __forceinline__ int64_t co_rank(int64_t d, int64_t la, int64_t lb,
                                           FA A, FB B, bool ties) {
  int64_t lo = d > lb ? d - lb : 0;
  int64_t hi = d < la ? d : la;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a_first(A(mid), B(d - 1 - mid), ties)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// split[(g * pairs + p) * (tiles + 1) + t] = co-rank of diagonal t * TILE
// (clamped to the merge's length).
template <int KIND, bool FIRST>
__global__ void partition_kernel(Level L, int64_t groups) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_pair = L.tiles + 1;
  if (t >= groups * L.pairs * per_pair) return;
  const int64_t gp = t / per_pair;
  const int p = (int)(gp % L.pairs);
  const int64_t g = gp / L.pairs;
  const Pair P = pair_of<KIND>(L, p);
  const int64_t tile_d = (t % per_pair) * TILE;
  const int64_t d = tile_d < P.la + P.lb ? tile_d : P.la + P.lb;
  L.split[t] = (int32_t)co_rank(
      d, P.la, P.lb,
      [&](int64_t i) { return load_key<KIND, FIRST>(L, g, false, P.a0 + i); },
      [&](int64_t j) { return load_key<KIND, FIRST>(L, g, true, P.b0 + j); },
      L.a_wins_ties);
}

// One block per output tile (g, p, t): stage the tile's slices of A and B,
// merge ITEMS outputs per thread, write keys (TREE, not last), ranks (TREE,
// last) or counts (TWO).
template <int KIND, bool FIRST, bool LAST>
__global__ void __launch_bounds__(THREADS) merge_kernel(Level L) {
  __shared__ uint64_t sk[TILE];
  const int64_t blk = blockIdx.x;
  const int tile = (int)(blk % L.tiles);
  const int64_t gp = blk / L.tiles;
  const int p = (int)(gp % L.pairs);
  const int64_t g = gp / L.pairs;
  const Pair P = pair_of<KIND>(L, p);
  const int64_t total = P.la + P.lb;
  const int64_t d0 = (int64_t)tile * TILE;
  if (d0 >= total) return;  // the whole block: this merge is shorter
  const int n = (int)(total - d0 < TILE ? total - d0 : TILE);
  const int32_t* sp = L.split + gp * (L.tiles + 1) + tile;
  const int64_t i0 = sp[0];
  const int na_t = (int)(sp[1] - i0);
  const int nb_t = n - na_t;
  const int64_t j0 = d0 - i0;
  for (int x = threadIdx.x; x < n; x += THREADS) {
    sk[x] = x < na_t ? load_key<KIND, FIRST>(L, g, false, P.a0 + i0 + x)
                     : load_key<KIND, FIRST>(L, g, true, P.b0 + j0 + x - na_t);
  }
  __syncthreads();
  const uint64_t* sa = sk;
  const uint64_t* sb = sk + na_t;
  const bool ties = L.a_wins_ties;
  const int dd = threadIdx.x * ITEMS < n ? threadIdx.x * ITEMS : n;
  int ia = (int)co_rank(
      dd, na_t, nb_t, [&](int64_t i) { return sa[i]; },
      [&](int64_t j) { return sb[j]; }, ties);
  int ib = dd - ia;
  const int m = n - dd < ITEMS ? n - dd : ITEMS;
  uint64_t ha = ia < na_t ? sa[ia] : 0, hb = ib < nb_t ? sb[ib] : 0;
  // TREE: the merged key; TWO: (tile-local a index << 32) | count, or ~0
  // for an entry of b
  uint64_t v[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    if (u < m) {
      const bool take_a = ia < na_t && (ib >= nb_t || a_first(ha, hb, ties));
      if (KIND == TWO) {
        v[u] = take_a ? ((uint64_t)ia << 32) |
                            (uint32_t)(d0 + dd + u - (i0 + ia))
                      : ~0ull;
      } else {
        v[u] = take_a ? ha : hb;
      }
      if (take_a) {
        if (++ia < na_t) ha = sa[ia];
      } else {
        if (++ib < nb_t) hb = sb[ib];
      }
    }
  }
  if (KIND == TREE && LAST) {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      if (u < m) {
        L.out[g * L.n + (uint32_t)v[u]] = (int32_t)(P.a0 + d0 + dd + u);
      }
    }
    return;
  }
  __syncthreads();  // every thread is done reading the tile's keys
  if (KIND == TWO) {
    int32_t* sc = reinterpret_cast<int32_t*>(sk);
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      if (u < m && v[u] != ~0ull) sc[v[u] >> 32] = (int32_t)(uint32_t)v[u];
    }
    __syncthreads();
    for (int x = threadIdx.x; x < na_t; x += THREADS) {
      L.out[g * L.na + i0 + x] = sc[x];
    }
  } else {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      if (u < m) sk[dd + u] = v[u];
    }
    __syncthreads();
    uint64_t* dst = L.keys_out + g * L.n + P.a0 + d0;
    for (int x = threadIdx.x; x < n; x += THREADS) dst[x] = sk[x];
  }
}

// The whole merge tree of group blockIdx.x in shared memory (2 * n uint64
// keys, ping-pong): each level's n outputs are cut evenly over the
// threads, each thread finds its first output's co-rank in its pair and
// merges serially; the last level writes the ranks.
__global__ void __launch_bounds__(THREADS) tree_in_smem_kernel(
    const int64_t* __restrict__ runs, int32_t* __restrict__ out, int k,
    int cap, int levels) {
  extern __shared__ uint64_t keys[];
  const int n = k * cap;
  uint64_t* src = keys;
  uint64_t* dst = keys + n;
  const int64_t g = blockIdx.x;
  for (int x = threadIdx.x; x < n; x += THREADS) {
    src[x] = ((uint64_t)(uint32_t)__ldg(runs + g * n + x) << 32) | (uint64_t)x;
  }
  __syncthreads();
  const int per = (n + THREADS - 1) / THREADS;
  const int first = threadIdx.x * per < n ? threadIdx.x * per : n;
  const int last_out = first + per < n ? first + per : n;
  for (int l = 0; l < levels; ++l) {
    const int seg = cap << l;
    const bool last = l + 1 == levels;
    for (int d = first; d < last_out;) {
      const int a0 = d / (2 * seg) * (2 * seg);  // the pair holding output d
      const int a1 = a0 + seg < n ? a0 + seg : n;
      const int b1 = a1 + seg < n ? a1 + seg : n;
      const uint64_t* A = src + a0;
      const uint64_t* B = src + a1;
      const int la = a1 - a0, lb = b1 - a1;
      int ia = (int)co_rank(
          d - a0, la, lb, [&](int64_t i) { return A[i]; },
          [&](int64_t j) { return B[j]; }, true);
      int ib = d - a0 - ia;
      for (const int stop = last_out < b1 ? last_out : b1; d < stop; ++d) {
        const bool take_a = ia < la && (ib >= lb || A[ia] <= B[ib]);
        const uint64_t key = take_a ? A[ia++] : B[ib++];
        if (last) {
          out[g * n + (uint32_t)key] = d;
        } else {
          dst[d] = key;
        }
      }
    }
    if (!last) {
      __syncthreads();  // the level is merged; the next reads it
      uint64_t* t = src;
      src = dst;
      dst = t;
    }
  }
}

template <int KIND, bool FIRST, bool LAST>
void run_level(const Level& L, int64_t groups, cudaStream_t s) {
  const int64_t splits = groups * L.pairs * (int64_t)(L.tiles + 1);
  partition_kernel<KIND, FIRST>
      <<<(unsigned)((splits + THREADS - 1) / THREADS), THREADS, 0, s>>>(
          L, groups);
  merge_kernel<KIND, FIRST, LAST>
      <<<(unsigned)(groups * L.pairs * L.tiles), THREADS, 0, s>>>(L);
}

int64_t tiles_of(int64_t n) { return (n + TILE - 1) / TILE; }

// Levels of the merge tree over k runs (at least one: k = 1 is a copy).
int levels_of(int k) {
  int l = 0;
  while ((1 << l) < k) ++l;
  return l > 0 ? l : 1;
}

struct Plan {
  int64_t split_ints, key_buffers;
};

// Shared memory a block may take on this device (opt-in limit).
int smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Mode 2 runs the tree in shared memory when a group's keys fit twice.
bool in_smem(int k, long long cap) {
  return (long long)k * cap * 16 <= smem_limit();
}

Plan plan(long long groups, int k, long long cap, int mode) {
  if (mode != 2) return {groups * (tiles_of(cap) + 1), 0};
  if (in_smem(k, cap)) return {0, 0};
  const int levels = levels_of(k);
  const int64_t n = (int64_t)k * cap;
  int64_t most = 0;
  for (int l = 0; l < levels; ++l) {
    const int64_t seg = (int64_t)cap << l;
    const int64_t pairs = (k + (2LL << l) - 1) / (2LL << l);
    const int64_t len = 2 * seg < n ? 2 * seg : n;
    const int64_t ints = groups * pairs * (tiles_of(len) + 1);
    if (ints > most) most = ints;
  }
  return {most, levels >= 3 ? 2 : levels - 1};
}

size_t split_bytes(int64_t ints) {
  return (size_t)((ints * 4 + 15) / 16 * 16);
}

}  // namespace

// Bytes of scratch `repro_rank_counts` needs: the splitters and, in mode
// 2, up to two uint64 key buffers of groups * k * cap entries.  Modes 0/1
// pass k = 1 and cap = na + nb (the merge's length).
extern "C" long long repro_rank_counts_scratch(long long groups, int k,
                                               long long cap, int mode) {
  const Plan P = plan(groups, k, cap, mode);
  return (long long)(split_bytes(P.split_ints) +
                     (size_t)P.key_buffers * groups * k * cap * 8);
}

// a: [groups, q_per_group, na]; b: [groups, s_per_group, nb]; out like a.
// mode 0: count b <= a; mode 1: count b < a (both with q = s = 1);
// mode 2: merge rank of the k = q = s runs of each group (a == b,
// na == nb == cap).  scratch: repro_rank_counts_scratch(groups, 1,
// na + nb, mode) bytes (modes 0/1) or (groups, k, cap, 2).
extern "C" int repro_rank_counts(const void* a, const void* b, void* out,
                                 void* scratch, long long groups,
                                 int q_per_group, long long na,
                                 int s_per_group, long long nb, int mode,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (groups <= 0 || na <= 0) return (int)cudaGetLastError();
  Level L{};
  L.out = (int32_t*)out;
  L.split = (int32_t*)scratch;
  if (mode != 2) {
    if (q_per_group != 1 || s_per_group != 1 || na + nb >= (1LL << 31)) {
      return (int)cudaErrorInvalidValue;
    }
    L.a = (const int64_t*)a;
    L.b = (const int64_t*)b;
    L.na = na;
    L.nb = nb;
    L.pairs = 1;
    L.tiles = (int)tiles_of(na + nb);
    L.a_wins_ties = mode == 1;
    run_level<TWO, true, true>(L, groups, s);
    return (int)cudaGetLastError();
  }
  const int k = q_per_group;
  if (k != s_per_group || na != nb || (int64_t)k * na >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int levels = levels_of(k);
  if (in_smem(k, na)) {
    const size_t bytes = (size_t)k * na * 16;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          tree_in_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    tree_in_smem_kernel<<<(unsigned)groups, THREADS, bytes, s>>>(
        (const int64_t*)a, (int32_t*)out, k, (int)na, levels);
    return (int)cudaGetLastError();
  }
  const Plan P = plan(groups, k, na, 2);
  uint64_t* keys = (uint64_t*)((char*)scratch + split_bytes(P.split_ints));
  uint64_t* buf[2] = {keys, keys + groups * k * na};
  L.n = (int64_t)k * na;
  L.a = (const int64_t*)a;
  L.a_wins_ties = true;
  for (int l = 0; l < levels; ++l) {
    const bool first = l == 0, last = l == levels - 1;
    L.seg = (int64_t)na << l;
    L.pairs = (int)((k + (2LL << l) - 1) / (2LL << l));
    L.tiles = (int)tiles_of(2 * L.seg < L.n ? 2 * L.seg : L.n);
    L.keys_in = first ? nullptr : buf[(l - 1) & 1];
    L.keys_out = last ? nullptr : buf[l & 1];
    if (first && last) {
      run_level<TREE, true, true>(L, groups, s);
    } else if (first) {
      run_level<TREE, true, false>(L, groups, s);
    } else if (last) {
      run_level<TREE, false, true>(L, groups, s);
    } else {
      run_level<TREE, false, false>(L, groups, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
