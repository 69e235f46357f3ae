// P2 selection (density greedy under per-ES budgets) for every seed in one
// launch: density, sort and budget walk, no host sync.
//
// Replaces two pieces of the reference:
//   * the TPU kernel src/repro/kernels/budgeted_topk/kernel.py,
//     density_sort_kernel (:96, launched at :112): the P2 density
//     value / max(cost, 1e-12), -inf where the pair is not eligible, and a
//     bitonic sort of each client tile by (density desc, flat index desc);
//   * the walk that consumes its sorted segments,
//     src/repro/kernels/budgeted_topk/ops.py, greedy_walk (:170) as
//     budgeted_topk (:299) calls it: one pick per iteration, the best
//     still-feasible head across the segments.
// In: values (S, N, M) f32, costs (S, N) f32, budgets (S, M) f32, eligible
// (S, N, M) bool. Out: assign (S, N) int32 (-1 = unselected) and remaining
// (S, M) f32, the budgets after the walk.
//
// Bound on the H100. Bytes, each input read once and each output written
// once: at the main path's (2, 1000, 12) values 96,000 B, eligible 24,000,
// costs 8,000, budgets 96, assign 8,000, remaining 96: ~136 KB, 0.041 us at
// 3.35 TB/s. That is not what limits it. The walk is a dependent chain: each
// pick reads and writes the ES's budget and the client's flag before the
// next pick can be tested, ~30 cycles of shared memory each, ~205 picks a
// seed on metropolis-1k: a latency floor of ~3 us at 1.98 GHz.
//
// Why one pass is exact. The pick order is a strict total order (density
// desc, ties toward the larger flat index client * M + es). While costs are
// >= 0 feasibility only shrinks (an assigned client stays assigned, a
// budget only falls), so a candidate found infeasible once stays so, and
// one pass over the sorted list taking each candidate feasible when reached
// makes the reference's picks in its order; each ES's budget is reduced by
// the same costs in the same order, so `remaining` is bitwise the same. A
// pick that raises its ES's budget (only a negative cost can) may make a
// passed candidate feasible again: the pass then restarts from the head of
// the list, which is the reference's next step (its best feasible
// candidate); at most N picks, so at most N restarts.
//
// Design: one block of 1024 threads per seed, all seeds in one launch, the
// seed's whole state in shared memory (N * M <= 16384 pairs: 128 KB of
// keys, N costs, M budgets, an N-bit mask of assigned clients).
//   1. Density, IEEE division with the reference's clamp (a NaN cost stays
//      NaN, as jnp.maximum and torch.clamp leave it). Only density > 0 can
//      ever be picked (the reference's walk tests it), which drops -inf,
//      0, -0.0 and NaN: ~3,400 of metropolis-1k's 12,000 pairs remain. They
//      are compacted with a warp ballot and one shared atomic a warp into
//      64-bit keys (float bits << 32) | (client << 14 | es); for positive
//      floats the bits order as the floats, and (client, es) orders as the
//      flat index since es < M <= 2^14. The compacted order depends on the
//      atomics' order; the sort that follows removes that.
//   2. Bitonic sort, descending, of P = max(256, next power of two >= the
//      compacted count) keys, sized at run time, zero keys as padding. E = 8
//      keys a thread (16 when P > 8192) in registers: distances below E in
//      registers, below 32 E with __shfl_xor_sync, the rest in shared memory
//      with one barrier a stage (14 barriers at P = 4096, against 66 for
//      the tile sort of 2,048 this replaces). Shared slots are rotated per
//      thread so that a warp's 64-bit accesses hit no bank twice per half.
//   3. The walk, one warp, 32 sorted keys at a time: each lane tests its
//      candidate (client free, cost <= remaining[es] + 1e-12 in float32);
//      in lane order, a feasible lane picks (remaining[es] + (-cost),
//      client marked, assign written) and the lanes after it are tested
//      again. A pick in lane i can only make lanes after i infeasible
//      (lanes before it were already), through the same client or the
//      same ES, so the lanes resolve in registers on masks of the lanes
//      sharing each, several picks a round (see walk).
//   4. assign is written as picks happen (-1 first), remaining at the end.
// The keys-only launch (budgeted_topk_keys_launch) is the same kernel
// without the walk, for P3, whose walk is flgreedy_walk.cu: step 1 keeps
// every pair of density > -inf (eligible, not NaN; P3 rescores them all),
// the key's high word is an order-preserving image of any float (-0.0
// taken as +0.0), and after step 2 the seed's sorted keys and their count
// are written out, zeros after them: the reference's build_segments
// (src/repro/kernels/budgeted_topk/ops.py, as flgreedy_topk at :315 calls
// it) over one segment a seed.
// Built with --fmad=false; nothing here would contract, and the flag keeps
// it so. No allocation, no synchronisation; PyTorch's current stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPairs = 16384;             // N * M a seed, in shared memory
constexpr int kPer = kMaxPairs / kThreads;   // pairs a thread in step 1
constexpr int kMinSort = 256;                // 32 lanes x 8 keys
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;               // the reference's float32 1e-12

typedef unsigned long long u64;

// Shared slot of sorted position q when thread q / E holds positions
// q / E * E .. + E - 1: each thread's run of E is rotated by its index
// (shifted so that the 16 lanes of a half-warp cover 16 distinct 8-byte
// bank pairs). A bijection on [0, P) that keeps every run in place.
template <int E>
__device__ __forceinline__ int phys(int q) {
  constexpr int kShift = E >= 16 ? 0 : (E == 8 ? 1 : 2);
  const int t = q / E;
  return t * E + ((q + (t >> kShift)) & (E - 1));
}

// Order the pair (x at the lower position, y): descending when `desc`.
__device__ __forceinline__ void cas(u64& x, u64& y, bool desc) {
  const bool sw = (x < y) == desc;
  const u64 a = sw ? y : x, b = sw ? x : y;
  x = a;
  y = b;
}

// Stages of distance J, J/2, .., 1 of the merge of size k, within a
// thread's E keys (positions base .. base + E - 1).
template <int E, int J>
__device__ __forceinline__ void reg_merge(u64 (&v)[E], int base, int k) {
  if constexpr (J > 0) {
#pragma unroll
    for (int r = 0; r < E; ++r)
      if ((r & J) == 0) cas(v[r], v[r | J], ((base + r) & k) == 0);
    reg_merge<E, J / 2>(v, base, k);
  }
}

// The merges of size K .. E, all within a thread.
template <int E, int K>
__device__ __forceinline__ void reg_sort(u64 (&v)[E], int base) {
  if constexpr (K <= E) {
    reg_merge<E, K / 2>(v, base, K);
    reg_sort<E, K * 2>(v, base);
  }
}

// One stage of distance j (E <= j < 32 E) across the lanes of a warp.
template <int E>
__device__ __forceinline__ void shfl_stage(u64 (&v)[E], int base, int k,
                                           int j) {
  const bool upper = (base & j) != 0;
  const bool keep_max = ((base & k) == 0) != upper;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const u64 o = __shfl_xor_sync(kFull, v[r], j / E);
    v[r] = ((o > v[r]) == keep_max) ? o : v[r];
  }
}

template <int E>
__device__ __forceinline__ void store_run(u64* s, const u64 (&v)[E],
                                          int base) {
#pragma unroll
  for (int r = 0; r < E; ++r) s[phys<E>(base + r)] = v[r];
}

template <int E>
__device__ __forceinline__ void load_run(const u64* s, u64 (&v)[E],
                                         int base) {
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = s[phys<E>(base + r)];
}

// Sort keys[0 .. count) (raw compacted order) descending into keys[phys(q)],
// q < P. Every thread of the block calls it (it has barriers); threads at
// or past P / E take part in the shared-memory stages only.
template <int E>
__device__ void sort_desc(u64* keys, int count, int p) {
  const int tid = threadIdx.x;
  const int nt = p / E;                      // a multiple of 32
  const bool active = tid < nt;              // warp-uniform
  const int base = tid * E;
  u64 v[E];
  if (active) {
    // the input is a multiset: any placement sorts to the same output, so
    // read it coalesced
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int q = r * nt + tid;
      v[r] = q < count ? keys[q] : 0ull;
    }
    reg_sort<E, 2>(v, base);
  }
  __syncthreads();                           // raw reads before slot writes
  for (int k = 2 * E; k <= p; k <<= 1) {
    if ((k >> 1) >= 32 * E) {                // distances across warps
      if (active) store_run<E>(keys, v, base);
      __syncthreads();
      for (int j = k >> 1; j >= 32 * E; j >>= 1) {
        for (int pr = tid; pr < (p >> 1); pr += kThreads) {
          const int a = ((pr & ~(j - 1)) << 1) | (pr & (j - 1));
          const int ia = phys<E>(a), ib = phys<E>(a + j);
          u64 x = keys[ia], y = keys[ib];
          if ((x < y) == ((a & k) == 0)) {
            keys[ia] = y;
            keys[ib] = x;
          }
        }
        __syncthreads();
      }
      if (active) load_run<E>(keys, v, base);
    }
    if (active) {
      for (int j = min(k >> 1, 16 * E); j >= E; j >>= 1)
        shfl_stage<E>(v, base, k, j);
      reg_merge<E, E / 2>(v, base, k);
    }
  }
  if (active) store_run<E>(keys, v, base);
  __syncthreads();
}

// The budget walk over the sorted keys, by one warp, kBatch groups of 32
// candidates at a time. A batch reads its keys and costs, and notes which
// groups have a feasible lane now: a group with none stays so (state only
// shrinks until a budget grows, and then the pass restarts), so it costs
// one vote. A live group re-reads its lanes' budgets and client flags and
// the masks of lanes sharing its client or its ES, then resolves its picks
// in registers, in rounds (see below; a group holding a negative cost
// takes one pick at a time instead, and a pick that raised a budget ends
// the batch and restarts the pass from the head). The group's picks are
// written to shared memory when it is done.
constexpr int kBatch = 8;
constexpr unsigned kNone = 0xffffffffu;      // no candidate in this lane

template <int E>
__device__ void walk(const u64* keys, int count, const float* s_cost,
                     float* s_rem, unsigned* s_taken, int* asg) {
  const int lane = threadIdx.x & 31;
  int pos = 0;
  while (pos < count) {
    unsigned word[kBatch];
    float c[kBatch];
    unsigned live = 0u, neg = 0u;            // bit g: group g (warp-uniform)
#pragma unroll
    for (int g = 0; g < kBatch; ++g) {
      const int q = pos + 32 * g + lane;
      word[g] = q < count ? (unsigned)keys[phys<E>(q)] : kNone;
    }
    // every load of the batch at once, without branches: a lane with no
    // candidate reads slot 0 and ignores it
#pragma unroll
    for (int g = 0; g < kBatch; ++g) {
      const unsigned wd = word[g] != kNone ? word[g] : 0u;
      c[g] = s_cost[wd >> 14];
    }
#pragma unroll
    for (int g = 0; g < kBatch; ++g) {
      const bool valid = word[g] != kNone;
      const unsigned wd = valid ? word[g] : 0u;
      const bool ok = valid &
                      !((s_taken[wd >> 19] >> ((wd >> 14) & 31)) & 1u) &
                      (c[g] <= s_rem[wd & 0x3fffu] + kEps);
      live |= (__ballot_sync(kFull, ok) != 0u ? 1u : 0u) << g;
      neg |= (__ballot_sync(kFull, valid & (c[g] < 0.f)) != 0u ? 1u : 0u)
             << g;
    }
    bool restart = false;
#pragma unroll
    for (int g = 0; g < kBatch; ++g) {
      if (!((live >> g) & 1u)) continue;
      const bool valid = word[g] != kNone;
      const int client = (int)(word[g] >> 14), es = (int)(word[g] & 0x3fffu);
      const unsigned wd = valid ? word[g] : 0u;
      float room = s_rem[wd & 0x3fffu];
      bool ok = valid & !((s_taken[wd >> 19] >> ((wd >> 14) & 31)) & 1u) &
                (c[g] <= room + kEps);
      unsigned hit = __ballot_sync(kFull, ok);
      if (!hit) continue;
      const unsigned same_es = __match_any_sync(kFull, es);
      const unsigned same_cl = __match_any_sync(kFull, client);
      bool picked = false;
      if (!((neg >> g) & 1u)) {
        // Budgets only fall here, so a lane infeasible now stays so, and a
        // feasible lane's fate depends only on the feasible lanes before
        // it with its ES (the budget they leave) or its client (taken or
        // not). Each round decides every lane whose such lanes are all
        // decided: at most one a chain (ES or client), so each chain's
        // budget falls by its picks in lane order, one shuffle a round.
        const unsigned below = (1u << lane) - 1u;
        const unsigned deps = (same_es | same_cl) & below;
        unsigned open = hit, took_all = 0u;
        do {
          const bool ready = ((open >> lane) & 1u) && !(deps & open);
          const bool take = ready && !(same_cl & below & took_all) &&
                            c[g] <= room + kEps;
          const unsigned took = __ballot_sync(kFull, take);
          open &= ~__ballot_sync(kFull, ready);
          took_all |= took;
          picked = picked || take;
          const unsigned src = same_es & took;  // this chain's pick, if any
          const float left = __shfl_sync(
              kFull, room + (-c[g]), src ? __ffs(src) - 1 : lane);
          if (src) room = left;
        } while (open);
      } else {
        // a negative cost: one pick at a time, and a pick that raised a
        // budget restarts the pass
        do {
          const int w = __ffs(hit) - 1;
          const float left = __shfl_sync(kFull, room + (-c[g]), w);
          picked = picked || lane == w;
          const bool chain = (same_es >> w) & 1u;
          restart = __any_sync(kFull, chain && left > room);
          if (chain) room = left;
          if (restart) break;
          ok = ok & (lane > w) & !((same_cl >> w) & 1u) &
               (c[g] <= room + kEps);
          hit = __ballot_sync(kFull, ok);
        } while (hit);
      }
      if (picked) {           // room: its ES's budget after the group's picks
        atomicOr(&s_taken[client >> 5], 1u << (client & 31));
        s_rem[es] = room;
        asg[client] = es;
      }
      __syncwarp();
      if (restart) break;
    }
    pos = restart ? 0 : pos + 32 * kBatch;
  }
}

// The high word of a keys-only key: unsigned, ordered as the floats are.
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned u = __float_as_uint(d + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int E>
__device__ void write_keys(const u64* keys, int count, int cap,
                           u64* __restrict__ out) {
  for (int q = threadIdx.x; q < cap; q += kThreads)
    out[q] = q < count ? keys[phys<E>(q)] : 0ull;
}

template <bool kKeys>
__global__ void __launch_bounds__(kThreads, 1)
budgeted_topk_kernel(const float* __restrict__ values,
                     const float* __restrict__ costs,
                     const float* __restrict__ budgets,
                     const unsigned char* __restrict__ eligible,
                     int* __restrict__ assign, float* __restrict__ remaining,
                     u64* __restrict__ keys_out, int* __restrict__ counts,
                     int n, int m, int key_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  float* s_cost = reinterpret_cast<float*>(keys + key_cap);
  float* s_rem = s_cost + n;
  unsigned* s_taken = reinterpret_cast<unsigned*>(s_rem + m);
  __shared__ int s_count;

  const int tid = threadIdx.x, lane = tid & 31;
  const long long seed = blockIdx.x;
  const int nm = n * m;
  const float* vals = values + seed * nm;
  const unsigned char* elig = eligible + seed * nm;
  int* asg = kKeys ? nullptr : assign + seed * n;

  // the pair loads first: their latency overlaps the set-up below
  float vv[kPer];
  unsigned char ee[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int q = i * kThreads + tid;
    vv[i] = q < nm ? vals[q] : 0.f;
    ee[i] = q < nm ? elig[q] : 0;
  }
  if (tid == 0) s_count = 0;
  for (int i = tid; i < n; i += kThreads) {
    s_cost[i] = costs[seed * n + i];
    if (!kKeys) asg[i] = -1;
  }
  if (!kKeys) {
    for (int i = tid; i < m; i += kThreads) s_rem[i] = budgets[seed * m + i];
    for (int i = tid; i < (n + 31) / 32; i += kThreads) s_taken[i] = 0u;
  }
  __syncthreads();

  // 1. density > 0, compacted into keys[0 .. count): a first pass computes
  // the densities and the warp's count, one atomic a warp reserves its
  // slots, a second pass writes the keys. Pair q = i * 1024 + tid is
  // (client, es) = divmod(q, m), stepped without a division.
  const int mm = m > 0 ? m : 1;              // m = 0: no pairs
  const int step_c = kThreads / mm, step_e = kThreads % mm;
  const int client0 = tid / mm, es0 = tid % mm;
  unsigned keepbits = 0;
  int total = 0;
  {
    int client = client0, es = es0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      bool keep = false;
      if (ee[i]) {                           // i * 1024 + tid < nm
        const float c = s_cost[client];
        vv[i] = vv[i] / (c < kEps ? kEps : c);
        keep = kKeys ? vv[i] > __uint_as_float(0xff800000u) : vv[i] > 0.f;
      }
      keepbits |= (unsigned)keep << i;
      total += __popc(__ballot_sync(kFull, keep));
      client += step_c;
      es += step_e;
      if (es >= mm) {
        es -= mm;
        ++client;
      }
    }
  }
  int at = 0;
  if (lane == 0 && total) at = atomicAdd(&s_count, total);
  at = __shfl_sync(kFull, at, 0);
  {
    int client = client0, es = es0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const bool keep = (keepbits >> i) & 1u;
      const unsigned b = __ballot_sync(kFull, keep);
      if (keep)
        keys[at + __popc(b & ((1u << lane) - 1u))] =
            ((u64)(kKeys ? order_key(vv[i]) : __float_as_uint(vv[i]))
             << 32) |
            (((unsigned)client << 14) | (unsigned)es);
      at += __popc(b);
      client += step_c;
      es += step_e;
      if (es >= mm) {
        es -= mm;
        ++client;
      }
    }
  }
  __syncthreads();
  const int count = s_count;

  // 2-3. sort, then walk (block-uniform branches)
  int p = kMinSort;
  while (p < count) p <<= 1;
  if (kKeys) {
    u64* out = keys_out + seed * key_cap;
    if (tid == 0) counts[seed] = count;
    if (p > 8192) {
      sort_desc<16>(keys, count, p);
      write_keys<16>(keys, count, key_cap, out);
    } else {
      if (count > 0) sort_desc<8>(keys, count, p);
      write_keys<8>(keys, count, key_cap, out);
    }
    return;
  }
  // phase-cost cut begin: sort-walk
  if (p > 8192) {
    sort_desc<16>(keys, count, p);
    // phase-cost cut begin: walk
    if (tid < 32) walk<16>(keys, count, s_cost, s_rem, s_taken, asg);
    // phase-cost cut end: walk
  } else if (count > 0) {
    sort_desc<8>(keys, count, p);
    // phase-cost cut begin: walk
    if (tid < 32) walk<8>(keys, count, s_cost, s_rem, s_taken, asg);
    // phase-cost cut end: walk
  }
  // phase-cost cut end: sort-walk
  // 4. the budgets left (warp 0 made every change to them)
  if (tid < 32)
    for (int i = lane; i < m; i += 32) remaining[seed * m + i] = s_rem[i];
}

// The TPU kernel's own layout, for more than kMaxPairs pairs a seed
// (density_sort_tiles_launch): one block a (client tile, seed) computes
// the tile's tile * M densities, -inf where ineligible or past N, and
// sorts them in shared memory by (density desc, flat index desc) with the
// sort above. A key is order_key(density) << 32 | (flat + 1); the row's
// pads past tile * M are (-inf, -1), key order_key(-inf) << 32, which
// sorts after every real -inf pair, as the plain version's composite key
// does (ref.density_sort_ref). Bound: each pair read once (values 4 B,
// eligible 1 B, its client's cost once) and written once as (density,
// flat), 8 B; a block holds one tile's P <= 16,384 keys (128 KB).
constexpr u64 kPadKey = (u64)0x007fffffu << 32;   // order_key(-inf), flat -1

template <int E>
__device__ void write_tile(const u64* keys, int p, float* __restrict__ d,
                           int* __restrict__ ix) {
  for (int q = threadIdx.x; q < p; q += kThreads) {
    const u64 k = keys[phys<E>(q)];
    const unsigned hi = (unsigned)(k >> 32), lo = (unsigned)k;
    d[q] = __uint_as_float((hi & 0x80000000u) ? (hi ^ 0x80000000u) : ~hi);
    ix[q] = (int)lo - 1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
density_sort_tiles_kernel(const float* __restrict__ values,
                          const float* __restrict__ costs,
                          const unsigned char* __restrict__ eligible,
                          float* __restrict__ d_out, int* __restrict__ i_out,
                          int n, int m, int tile, int p, int ps) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  const long long seed = blockIdx.y, ti = blockIdx.x, nt = gridDim.x;
  const int pairs = tile * m;
  const long long row0 = ti * tile;
  for (int q = threadIdx.x; q < ps; q += kThreads) {
    u64 key = kPadKey;
    if (q < pairs) {
      const int r = q / m;
      const long long row = row0 + r;
      float d = __uint_as_float(0xff800000u);          // -inf
      if (row < n) {
        const long long at = (seed * n + row) * m + (q - r * m);
        if (eligible[at]) {
          const float c = costs[seed * n + row];
          d = values[at] / (c < kEps ? kEps : c);
        }
      }
      key = ((u64)order_key(d) << 32) |
            (u64)((unsigned)(row0 * m + q) + 1u);
    }
    keys[q] = key;
  }
  __syncthreads();
  float* d = d_out + (seed * nt + ti) * p;
  int* ix = i_out + (seed * nt + ti) * p;
  if (ps > 8192) {
    sort_desc<16>(keys, ps, ps);
    write_tile<16>(keys, p, d, ix);
  } else {
    sort_desc<8>(keys, ps, ps);
    write_tile<8>(keys, p, d, ix);
  }
}

size_t key_capacity(int n, int m) {
  size_t cap = kMinSort;
  while (cap < (size_t)n * m) cap <<= 1;
  return cap;
}

}  // namespace

// Dynamic shared memory of one block at (N, M); 0 above the limit.
extern "C" long long budgeted_topk_smem(int n, int m) {
  if (n < 0 || m < 0 || (long long)n * m > kMaxPairs) return 0;
  return (long long)(key_capacity(n, m) * sizeof(u64) +
                     (size_t)(n + m) * sizeof(float) +
                     (size_t)((n + 31) / 32) * sizeof(unsigned));
}

extern "C" int budgeted_topk_launch(const float* values, const float* costs,
                                    const float* budgets,
                                    const unsigned char* eligible,
                                    int* assign, float* remaining, int s,
                                    int n, int m, void* stream) {
  if (n < 0 || m < 0 || (long long)n * m > kMaxPairs)
    return (int)cudaErrorInvalidValue;
  if (s == 0) return 0;
  const size_t smem = (size_t)budgeted_topk_smem(n, m);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        budgeted_topk_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  budgeted_topk_kernel<false><<<s, kThreads, smem, (cudaStream_t)stream>>>(
      values, costs, budgets, eligible, assign, remaining, nullptr, nullptr,
      n, m, (int)key_capacity(n, m));
  return (int)cudaGetLastError();
}

// Slots a seed of the keys-only output (a power of two >= N * M, >= 256).
extern "C" int budgeted_topk_key_capacity(int n, int m) {
  if (n < 0 || m < 0 || (long long)n * m > kMaxPairs) return 0;
  return (int)key_capacity(n, m);
}

extern "C" int budgeted_topk_keys_launch(const float* values,
                                         const float* costs,
                                         const unsigned char* eligible,
                                         unsigned long long* keys,
                                         int* counts, int s, int n, int m,
                                         void* stream) {
  if (n < 0 || m < 0 || (long long)n * m > kMaxPairs)
    return (int)cudaErrorInvalidValue;
  if (s == 0) return 0;
  const size_t smem = (size_t)budgeted_topk_smem(n, m);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        budgeted_topk_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  budgeted_topk_kernel<true><<<s, kThreads, smem, (cudaStream_t)stream>>>(
      values, costs, nullptr, eligible, nullptr, nullptr, keys, counts, n, m,
      (int)key_capacity(n, m));
  return (int)cudaGetLastError();
}

// The tile sort: values (S, N, M), costs (S, N), eligible (S, N, M) ->
// density (S, nt, P) f32 and flat index (S, nt, P) int32, nt = ceil(N /
// tile), P the next power of two >= tile * M (<= kMaxPairs).
extern "C" int density_sort_tiles_launch(const float* values,
                                         const float* costs,
                                         const unsigned char* eligible,
                                         float* d_out, int* i_out, int s,
                                         int n, int m, int tile,
                                         void* stream) {
  if (n < 0 || m <= 0 || tile <= 0 || (long long)tile * m > kMaxPairs ||
      ((long long)n + tile) * m >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int nt = (n + tile - 1) / tile;
  if (s == 0 || nt == 0) return 0;
  int p = 1;
  while (p < tile * m) p <<= 1;
  const int ps = p < kMinSort ? kMinSort : p;
  const size_t smem = (size_t)ps * sizeof(u64);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        density_sort_tiles_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  density_sort_tiles_kernel<<<dim3(nt, s), kThreads, smem,
                              (cudaStream_t)stream>>>(
      values, costs, eligible, d_out, i_out, n, m, tile, p, ps);
  return (int)cudaGetLastError();
}
