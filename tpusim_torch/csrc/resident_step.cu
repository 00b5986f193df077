// One step of the streaming twin's resident scan, group-free route, as one
// CUDA launch on Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs the resident scan as an XLA
// program (tpusim/jaxe/scan.py, the step of lax.scan); the port ran the same
// step as about 228 torch kernels (tpusim_torch/scan.py make_step over
// _evaluate and _select), replayed from CUDA graphs. This kernel is that
// step for the configurations scan.fused_step_eligible admits: the v1.10
// DefaultProvider without a policy, with no pod-group feature (ports,
// Services, inter-pod terms, disk conflicts, MaxPD volumes, volume zones),
// on one unsharded device. Every other configuration keeps make_step.
//
// What one launch computes, for pod t = *t1 (scan.make_step, bit for bit):
// the filter stages in predicatesOrdering over every node, a node's reason
// word being its first failing stage's bits (node conditions ->
// GeneralPredicates: pods, cpu, memory, gpu, ephemeral, scalar resources,
// hostname, node selector -> taints -> memory pressure for best-effort pods
// -> disk pressure); the weighted score (Least- or MostRequested, exact
// BalancedResourceAllocation, NodeAffinity and TaintToleration normalized
// by their maxima over the feasible nodes, NodePreferAvoidPods); selectHost
// (the max over every node of the score, -1 on an infeasible node, and the
// (rr mod ties)-th feasible tie in node order when more than one node is
// feasible); the bind into the carry rows; rr += (feasible > 1); the pod's
// rows of choices, counts (zeros when bound, else the reason histogram) and
// advanced; then *t1 += 1. The pod row is read at the index the device holds
// in t1, so the launch reads nothing from the host and a CUDA graph can
// capture it; the tensors are read and written where they lie, so the
// commits between cycles (apply_delta_, apply_statics_delta_,
// overlay_restore_) patch what the graph reads.
//
// Arithmetic is the torch step's int64: sums and products wrap as two's
// complement (computed unsigned), divisions floor. BalancedResourceAllocation
// is exact: the three products of two int64 operands are formed as unsigned
// 128-bit integers (the torch step's 16-bit limbs read a negative operand as
// its unsigned image too), and t * den >= 10 |num| is compared in 192 bits.
// No floating point.
//
// Design: one thread-block cluster of up to 16 CTAs over the node axis (the
// pattern of csrc/fastscan.cu). CTA r owns a contiguous slab of nodes and its
// threads own contiguous runs of it (one node a thread at 5,000 nodes), so
// node order is (rank, thread) order, and a carry cell is read and written
// only by the thread that owns its node: the bind needs no atomics and no
// cross-SM coherence. A node's reason word and score stay in the CTA's
// shared memory between the passes, so a CTA's slab holds at most 13,504
// nodes (kernels/resident_step.py MAX_SLAB). The CTAs meet at two cluster
// barriers, and every exchange is a push into the slot of the pushing rank
// in every CTA's shared memory, so each CTA then reduces the same slots in
// the same order: before the first, each CTA's feasible count and
// normalizer maxima; before the second, each CTA's (score max, feasible
// ties at it), or, when nothing fits, each CTA's reason histogram into rank
// 0. The barrier that makes every CTA of the cluster resident before the
// first push is split into an arrive at the start and a wait after pass 1,
// so it costs no extra round.
//
// Bound: a step reads about 17 int64 or bool node columns and signature rows
// over N nodes and writes one node's carry row: at 5,000 nodes under 1 MB,
// 0.28 us at 3.35 TB/s (portbench/roofline.py). All of it stays in the 50 MB
// L2 between steps, so neither memory nor arithmetic bounds the step: the
// chain of a launch, dependent loads (t1, the pod row, the node columns),
// two cluster barriers and their pushes does, and more CTAs shorten the
// per-thread node loop (16 CTAs beat 8, 4, 2 and 1 on 5,000 nodes).

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

typedef long long i64;
typedef unsigned long long u64;
typedef unsigned __int128 u128;

constexpr unsigned kFull = 0xffffffffu;
constexpr i64 kMaxPriority = 10;
// kernels/resident_step.py MAX_THREADS, CLUSTER_SIZES, MAX_BITS
constexpr int kMaxThreads = 512, kMaxCluster = 16, kMaxBits = 64;
constexpr int kMaxWarps = kMaxThreads / 32;
// reason bits (tpusim_torch/state.py)
constexpr int kBitPods = 4, kBitCpu = 5, kBitMem = 6, kBitGpu = 7,
              kBitEph = 8, kBitHost = 9, kBitSel = 10, kBitTaint = 11,
              kBitMemPressure = 12, kBitDiskPressure = 13, kFixedBits = 24;
// the packed pod row (scan._pod_layout, PodX order): the S scalar requests
// sit at P_SCALAR, and every column after them is shifted by S
enum { P_RC, P_RM, P_RG, P_RE, P_SCALAR };
enum { Q_NZC, Q_NZM, Q_ZERO, Q_BE, Q_SEL, Q_TOL, Q_AFF, Q_AVOID, Q_HOST,
       Q_GROUP, Q_IMG, Q_SA_SELF, Q_END };

struct Args {
  // the pods' packed rows [P, pod_w] and the device-held pod counter
  const i64* pods;
  i64* t1;
  // statics: node columns [N] and signature tables [rows, N]
  const i64 *alloc_cpu, *alloc_mem, *alloc_gpu, *alloc_eph, *allowed_pods,
      *cond, *alloc_scalar;
  const unsigned char *mem_pressure, *disk_pressure, *selector_ok, *taint_ok,
      *host_ok;
  const i64 *intolerable, *affinity_count, *avoid_score;
  // the carry, bound into in place; rr is a 0-d tensor
  i64 *used_cpu, *used_mem, *used_gpu, *used_eph, *used_scalar, *nonzero_cpu,
      *nonzero_mem, *pod_count, *rr;
  // the bucket's outputs
  int* choices;
  int* counts;
  unsigned char* advanced;
  int n, n_scal, pod_w, num_bits;
  // the score weights (config.policy_weights without a policy)
  i64 w_least, w_most, w_balanced, w_aff, w_taint, w_avoid;
};

__device__ __forceinline__ i64 wadd(i64 a, i64 b) {
  return (i64)((u64)a + (u64)b);
}
__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
  return (i64)((u64)a - (u64)b);
}
__device__ __forceinline__ i64 wmul(i64 a, i64 b) {
  return (i64)((u64)a * (u64)b);
}
__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }
// floor(a / b) for b > 0 (torch.div(rounding_mode="floor"))
__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  const i64 q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// least_requested.go:41-52 / most_requested.go:44-55 (scan._ratio_score)
__device__ __forceinline__ i64 ratio_score(i64 req, i64 cap, bool most) {
  if (!(cap > 0 && req <= cap)) return 0;
  return floordiv(wmul(most ? req : wsub(cap, req), kMaxPriority), cap);
}

// a nonnegative integer below 2^192: hi * 2^128 + lo
struct U192 {
  u64 hi;
  u128 lo;
};

__device__ __forceinline__ U192 mul_small(u128 x, u64 k) {
  const u128 r0 = (u128)(u64)x * k;
  const u128 r1 = (u128)(u64)(x >> 64) * k + (u64)(r0 >> 64);
  return U192{(u64)(r1 >> 64), (r1 << 64) | (u64)r0};
}

__device__ __forceinline__ bool ge(const U192& a, const U192& b) {
  return a.hi != b.hi ? a.hi > b.hi : a.lo >= b.lo;
}

// balanced_resource_allocation.go:39-63 as scan._balanced_score computes it:
// #{t in 0..9 : t * den >= 10 |num|}, num = rc am - rm ac, den = ac am
__device__ i64 balanced_score(i64 rc, i64 rm, i64 ac, i64 am) {
  if (ac == 0 || rc >= ac || am == 0 || rm >= am) return 0;
  const u128 p0 = (u128)(u64)rc * (u64)am;
  const u128 p1 = (u128)(u64)rm * (u64)ac;
  const u128 den = (u128)(u64)ac * (u64)am;
  const U192 d10 = mul_small(p0 >= p1 ? p0 - p1 : p1 - p0, kMaxPriority);
  // t den grows with t: the t that pass are those from the first that does
  u64 t = 0;
  while (t < (u64)kMaxPriority && !ge(mul_small(den, t), d10)) ++t;
  return kMaxPriority - (i64)t;
}

// the pod's columns and signature rows
struct Pod {
  i64 rc, rm, rg, re, nzc, nzm;
  bool check_res, best_effort;
  const i64* rs;
  const unsigned char *sel, *tol, *host;
  const i64 *intol, *aff, *avoid;
};

// the first failing stage's bits of node i (0: feasible). Every column is
// loaded before the first test, so a node's loads go out together rather
// than one round trip a stage
__device__ i64 node_reason(const Args& a, const Pod& p, int i) {
  const i64 cond = __ldg(a.cond + i);
  const i64 pods = a.pod_count[i], allowed = __ldg(a.allowed_pods + i);
  const i64 ac = __ldg(a.alloc_cpu + i), am = __ldg(a.alloc_mem + i);
  const i64 ag = __ldg(a.alloc_gpu + i), ae = __ldg(a.alloc_eph + i);
  const i64 uc = a.used_cpu[i], um = a.used_mem[i];
  const i64 ug = a.used_gpu[i], ue = a.used_eph[i];
  const bool host = __ldg(p.host + i), sel = __ldg(p.sel + i);
  const bool tol = __ldg(p.tol + i);
  const bool mem_pressure = __ldg(a.mem_pressure + i);
  const bool disk_pressure = __ldg(a.disk_pressure + i);
  // GeneralPredicates: resources, hostname, node selector
  i64 bits = wadd(pods, 1) > allowed ? 1LL << kBitPods : 0;
  if (p.check_res) {
    if (ac < wadd(p.rc, uc)) bits |= 1LL << kBitCpu;
    if (am < wadd(p.rm, um)) bits |= 1LL << kBitMem;
    if (ag < wadd(p.rg, ug)) bits |= 1LL << kBitGpu;
    if (ae < wadd(p.re, ue)) bits |= 1LL << kBitEph;
    const i64* al = a.alloc_scalar + (size_t)i * a.n_scal;
    const i64* us = a.used_scalar + (size_t)i * a.n_scal;
    for (int s = 0; s < a.n_scal; ++s)
      if (__ldg(al + s) < wadd(p.rs[s], us[s]))
        bits |= (i64)(1ULL << (kFixedBits + s));
  }
  if (!host) bits |= 1LL << kBitHost;
  if (!sel) bits |= 1LL << kBitSel;
  if (cond != 0) return cond;
  if (bits != 0) return bits;
  if (!tol) return 1LL << kBitTaint;
  if (mem_pressure && p.best_effort) return 1LL << kBitMemPressure;
  if (disk_pressure) return 1LL << kBitDiskPressure;
  return 0;
}

// the weighted score of feasible node i (scan._evaluate's sum)
__device__ i64 node_score(const Args& a, const Pod& p, int i, i64 aff_max,
                          i64 intol_max) {
  const i64 tc = wadd(p.nzc, a.nonzero_cpu[i]);
  const i64 tm = wadd(p.nzm, a.nonzero_mem[i]);
  const i64 ac = __ldg(a.alloc_cpu + i), am = __ldg(a.alloc_mem + i);
  const i64 aff = __ldg(p.aff + i), intol = __ldg(p.intol + i);
  const i64 avoid = __ldg(p.avoid + i);
  i64 s = 0;
  if (a.w_least)
    s = wadd(s, wmul(a.w_least, floordiv(wadd(ratio_score(tc, ac, false),
                                                  ratio_score(tm, am, false)),
                                             2)));
  if (a.w_most)
    s = wadd(s, wmul(a.w_most, floordiv(wadd(ratio_score(tc, ac, true),
                                                 ratio_score(tm, am, true)),
                                            2)));
  if (a.w_balanced)
    s = wadd(s, wmul(a.w_balanced, balanced_score(tc, tm, ac, am)));
  if (a.w_aff) {
    // NormalizeReduce(10, False) over the feasible nodes
    const i64 v =
        aff_max > 0 ? floordiv(wmul(kMaxPriority, aff), aff_max) : 0;
    s = wadd(s, wmul(a.w_aff, v));
  }
  if (a.w_taint) {
    // NormalizeReduce(10, True) over the feasible nodes
    const i64 v =
        intol_max > 0
            ? wsub(kMaxPriority, floordiv(wmul(kMaxPriority, intol), intol_max))
            : kMaxPriority;
    s = wadd(s, wmul(a.w_taint, v));
  }
  if (a.w_avoid) s = wadd(s, wmul(avoid, a.w_avoid));
  return s;
}

__device__ __forceinline__ i64 warp_max(i64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = imax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// CTA r of a cluster of c owns the nodes [32 floor(r u / c), 32 floor((r +
// 1) u / c)) of the u = ceil(N / 32) lane groups, cut at N (kernels/
// resident_step.py launch_geometry)
__device__ __forceinline__ int slab_lo(int rank, int units, int csize) {
  return 32 * (rank * units / csize);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    resident_step_kernel(Args a) {
  // a node's reason word and score, read and written only by its thread
  extern __shared__ i64 reason_s[];
  __shared__ i64 inbox[kMaxCluster][3];   // every CTA's nf, aff and intol max
  __shared__ i64 cmax_in[kMaxCluster];    // every CTA's score max
  __shared__ int ccnt_in[kMaxCluster];    // and its feasible ties at it
  __shared__ int hist_in[kMaxCluster][kMaxBits];  // rank 0: every histogram
  __shared__ i64 wmax[kMaxWarps];
  __shared__ int wcnt[kMaxWarps];
  __shared__ int hist[kMaxBits];
  __shared__ int acc_nf;
  __shared__ i64 acc_aff, acc_intol;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nwarps = nt >> 5;
  const int units = (a.n + 31) >> 5;
  const int slab = 32 * ((units + csize - 1) / csize);
  const int clo = slab_lo(rank, units, csize);
  const int chi = min(slab_lo(rank + 1, units, csize), a.n);
  const int per = (slab + nt - 1) / nt;
  const int lo = min(clo + tid * per, chi), hi = min(lo + per, chi);
  i64* score_s = reason_s + slab;
  if (tid == 0) {
    acc_nf = 0;
    acc_aff = 0;
    acc_intol = 0;
  }
  for (int b = tid; b < kMaxBits; b += nt) hist[b] = 0;
  cluster_arrive();

  const i64 t = *a.t1;
  const i64 rr = *a.rr;
  const i64* row = a.pods + (size_t)t * a.pod_w;
  const i64* q = row + P_SCALAR + a.n_scal;
  Pod p;
  p.rc = row[P_RC];
  p.rm = row[P_RM];
  p.rg = row[P_RG];
  p.re = row[P_RE];
  p.rs = row + P_SCALAR;
  p.nzc = q[Q_NZC];
  p.nzm = q[Q_NZM];
  p.check_res = q[Q_ZERO] == 0;
  p.best_effort = q[Q_BE] != 0;
  p.sel = a.selector_ok + (size_t)q[Q_SEL] * a.n;
  p.tol = a.taint_ok + (size_t)q[Q_TOL] * a.n;
  p.intol = a.intolerable + (size_t)q[Q_TOL] * a.n;
  p.aff = a.affinity_count + (size_t)q[Q_AFF] * a.n;
  p.avoid = a.avoid_score + (size_t)q[Q_AVOID] * a.n;
  p.host = a.host_ok + (size_t)q[Q_HOST] * a.n;

  // pass 1 over my nodes: reason words, the feasible count and the
  // normalizers' maxima over the feasible nodes (from 0, as the torch step's
  // max over where(feasible, v, 0); only their sign and value past 0 count)
  int nf = 0;
  i64 aff_max = 0, intol_max = 0;
  for (int i = lo; i < hi; ++i) {
    const i64 aff = __ldg(p.aff + i), intol = __ldg(p.intol + i);
    const i64 r = node_reason(a, p, i);
    reason_s[i - clo] = r;
    if (r != 0) continue;
    ++nf;
    aff_max = imax(aff_max, aff);
    intol_max = imax(intol_max, intol);
  }
  nf = __reduce_add_sync(kFull, nf);
  aff_max = warp_max(aff_max);
  intol_max = warp_max(intol_max);
  // every CTA of the cluster has started and zeroed its values
  cluster_wait();
  if (lane == 0) {
    if (nf != 0) atomicAdd(&acc_nf, nf);
    if (aff_max > 0) atomicMax(&acc_aff, aff_max);
    if (intol_max > 0) atomicMax(&acc_intol, intol_max);
  }
  __syncthreads();
  // my CTA's values into slot `rank` of every CTA
  if (tid < csize) {
    i64* dst = cluster.map_shared_rank(&inbox[0][0], tid) + 3 * rank;
    dst[0] = acc_nf;
    dst[1] = acc_aff;
    dst[2] = acc_intol;
  }
  // cluster barrier 1: every CTA's values are in every CTA
  cluster.sync();
  i64 n_feasible = 0;
  aff_max = intol_max = 0;
  for (int r = 0; r < csize; ++r) {
    n_feasible += inbox[r][0];
    aff_max = imax(aff_max, inbox[r][1]);
    intol_max = imax(intol_max, inbox[r][2]);
  }

  if (n_feasible > 0) {
    // pass 2: scores; each thread's max over its nodes of the score, -1 on
    // an infeasible node, and its feasible nodes at that max
    i64 lmax = LLONG_MIN;
    int lcnt = 0;
    for (int i = lo; i < hi; ++i) {
      const int l = i - clo;
      if (reason_s[l] != 0) {
        if (-1 > lmax) {
          lmax = -1;
          lcnt = 0;
        }
        continue;
      }
      const i64 s = node_score(a, p, i, aff_max, intol_max);
      score_s[l] = s;
      if (s > lmax) {
        lmax = s;
        lcnt = 1;
      } else if (s == lmax) {
        ++lcnt;
      }
    }
    // each warp's (max, ties at it), then my CTA's, pushed into slot `rank`
    // of every CTA
    const i64 wm = warp_max(lmax);
    const int wc = __reduce_add_sync(kFull, lmax == wm ? lcnt : 0);
    if (lane == 0) {
      wmax[warp] = wm;
      wcnt[warp] = wc;
    }
    __syncthreads();
    if (warp == 0) {
      const i64 m = lane < nwarps ? wmax[lane] : LLONG_MIN;
      const i64 cm = warp_max(m);
      const int cc = __reduce_add_sync(
          kFull, lane < nwarps && m == cm ? wcnt[lane] : 0);
      if (lane < csize) {
        *cluster.map_shared_rank(&cmax_in[rank], lane) = cm;
        *cluster.map_shared_rank(&ccnt_in[rank], lane) = cc;
      }
    }
    // cluster barrier 2: every CTA's pair is in every CTA
    cluster.sync();
    // every thread, from local copies: the max, the ties at it, and the
    // ties in the CTAs, warps and lanes before it ((rank, warp, lane) being
    // node order)
    i64 gmax = LLONG_MIN;
    for (int r = 0; r < csize; ++r) gmax = imax(gmax, cmax_in[r]);
    i64 ties = 0, before = 0;
    for (int r = 0; r < csize; ++r) {
      const int c = cmax_in[r] == gmax ? ccnt_in[r] : 0;
      ties += c;
      if (r < rank) before += c;
    }
    for (int w = 0; w < warp; ++w)
      if (wmax[w] == gmax) before += wcnt[w];
    const int tcnt = lmax == gmax ? lcnt : 0;
    int incl = tcnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    before += incl - tcnt;
    i64 k = 0;
    if (n_feasible > 1) {
      const i64 m = imax(ties, 1);
      k = rr % m;
      if (k < 0) k += m;
    }
    // the thread whose run holds the k-th tie binds it; with no feasible
    // node at the max (every feasible score below -1) the torch step's
    // argmax over no pick is node 0, which thread 0 of rank 0 owns
    int choice = -1;
    if (tcnt > 0 && before <= k && k < before + tcnt) {
      i64 seen = before;
      for (int i = lo; i < hi; ++i) {
        const int l = i - clo;
        if (reason_s[l] != 0 || score_s[l] != gmax) continue;
        if (seen == k) {
          choice = i;
          break;
        }
        ++seen;
      }
    } else if (ties == 0 && rank == 0 && tid == 0) {
      choice = 0;
    }
    if (choice >= 0) {
      a.used_cpu[choice] = wadd(a.used_cpu[choice], p.rc);
      a.used_mem[choice] = wadd(a.used_mem[choice], p.rm);
      a.used_gpu[choice] = wadd(a.used_gpu[choice], p.rg);
      a.used_eph[choice] = wadd(a.used_eph[choice], p.re);
      a.nonzero_cpu[choice] = wadd(a.nonzero_cpu[choice], p.nzc);
      a.nonzero_mem[choice] = wadd(a.nonzero_mem[choice], p.nzm);
      a.pod_count[choice] = wadd(a.pod_count[choice], 1);
      i64* us = a.used_scalar + (size_t)choice * a.n_scal;
      for (int s = 0; s < a.n_scal; ++s) us[s] = wadd(us[s], p.rs[s]);
      a.choices[t] = choice;
    }
    if (rank == 0) {
      for (int b = tid; b < a.num_bits; b += nt)
        a.counts[(size_t)t * a.num_bits + b] = 0;
      if (tid == 0) {
        a.advanced[t] = n_feasible > 1;
        *a.rr = wadd(rr, n_feasible > 1 ? 1 : 0);
        *a.t1 = t + 1;
      }
    }
  } else {
    // no node fits: the reason histogram over every node, my CTA's counts
    // pushed into slot `rank` of rank 0
    for (int b = 0; b < a.num_bits; ++b) {
      int c = 0;
      for (int i = lo; i < hi; ++i) c += (int)((reason_s[i - clo] >> b) & 1);
      c = __reduce_add_sync(kFull, c);
      if (lane == 0 && c != 0) atomicAdd(&hist[b], c);
    }
    __syncthreads();
    for (int b = tid; b < a.num_bits; b += nt)
      cluster.map_shared_rank(&hist_in[0][0], 0)[rank * kMaxBits + b] =
          hist[b];
    // cluster barrier 2: every CTA's histogram is in rank 0, which sums
    // them in rank order
    cluster.sync();
    if (rank == 0) {
      for (int b = tid; b < a.num_bits; b += nt) {
        int v = 0;
        for (int r = 0; r < csize; ++r) v += hist_in[r][b];
        a.counts[(size_t)t * a.num_bits + b] = v;
      }
      if (tid == 0) {
        a.choices[t] = -1;
        a.advanced[t] = 0;
        *a.t1 = t + 1;
      }
    }
  }
  // every push into another CTA's shared memory lies before the last
  // cluster barrier, so a CTA may leave here
}

// A launch configuration of one cluster of `cluster` CTAs; `attr` must
// outlive it
cudaError_t cluster_config(int cluster, int threads, int smem, cudaStream_t st,
                           cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || smem < 0)
    return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Sets the kernel's attributes for this geometry (a non-portable cluster
// size, the dynamic shared memory) and returns how many such clusters the
// card can hold at once (0: it cannot launch one); a negative value is a
// CUDA error, negated. Called before the first launch, outside any capture.
extern "C" int tpusim_resident_step_prepare(int cluster, int threads,
                                            int smem) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(cluster, threads, smem, nullptr, &attr, &cfg);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(resident_step_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(resident_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int count = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&count, resident_step_kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return count;
}

// One step: launches the kernel on `stream` and returns the launch's CUDA
// error (0 when it was queued).
extern "C" int tpusim_resident_step(
    const i64* pods, int pod_w, i64* t1, const i64* alloc_cpu,
    const i64* alloc_mem, const i64* alloc_gpu, const i64* alloc_eph,
    const i64* allowed_pods, const i64* cond, const i64* alloc_scalar,
    const unsigned char* mem_pressure, const unsigned char* disk_pressure,
    const unsigned char* selector_ok, const unsigned char* taint_ok,
    const unsigned char* host_ok, const i64* intolerable,
    const i64* affinity_count, const i64* avoid_score, i64* used_cpu,
    i64* used_mem, i64* used_gpu, i64* used_eph, i64* used_scalar,
    i64* nonzero_cpu, i64* nonzero_mem, i64* pod_count, i64* rr, int* choices,
    int* counts, unsigned char* advanced, int n, int n_scal,
    int num_bits, int w_least, int w_most, int w_balanced, int w_aff,
    int w_taint, int w_avoid, int cluster, int threads, int smem,
    void* stream) {
  // the dynamic shared memory holds two int64 a node of the slab
  const int units = (n + 31) / 32;
  if (n <= 0 || n_scal < 0 || kFixedBits + n_scal > kMaxBits ||
      num_bits > kMaxBits || pod_w != P_SCALAR + n_scal + Q_END ||
      cluster < 1 || cluster > units ||
      smem < 2 * 8 * 32 * ((units + cluster - 1) / cluster))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.pods = pods;
  a.t1 = t1;
  a.alloc_cpu = alloc_cpu;
  a.alloc_mem = alloc_mem;
  a.alloc_gpu = alloc_gpu;
  a.alloc_eph = alloc_eph;
  a.allowed_pods = allowed_pods;
  a.cond = cond;
  a.alloc_scalar = alloc_scalar;
  a.mem_pressure = mem_pressure;
  a.disk_pressure = disk_pressure;
  a.selector_ok = selector_ok;
  a.taint_ok = taint_ok;
  a.host_ok = host_ok;
  a.intolerable = intolerable;
  a.affinity_count = affinity_count;
  a.avoid_score = avoid_score;
  a.used_cpu = used_cpu;
  a.used_mem = used_mem;
  a.used_gpu = used_gpu;
  a.used_eph = used_eph;
  a.used_scalar = used_scalar;
  a.nonzero_cpu = nonzero_cpu;
  a.nonzero_mem = nonzero_mem;
  a.pod_count = pod_count;
  a.rr = rr;
  a.choices = choices;
  a.counts = counts;
  a.advanced = advanced;
  a.n = n;
  a.n_scal = n_scal;
  a.pod_w = pod_w;
  a.num_bits = num_bits;
  a.w_least = w_least;
  a.w_most = w_most;
  a.w_balanced = w_balanced;
  a.w_aff = w_aff;
  a.w_taint = w_taint;
  a.w_avoid = w_avoid;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(cluster, threads, smem, (cudaStream_t)stream,
                                 &attr, &cfg);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, resident_step_kernel, a);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}
