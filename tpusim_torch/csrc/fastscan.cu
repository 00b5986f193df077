// Fused fast scan, group-free variant, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpusim/jaxe/fastscan.py::_make_kernel (the
// Pallas kernel behind fast_scan), Variant 1: no pod groups, no inter-pod
// terms, no MaxPD volumes, no policy residue; up to 6 scalar resource axes
// and Least- or MostRequested.
//
// What it computes, for each pod of a chunk in order (kube-scheduler's
// scheduleOne): the filter stages in predicatesOrdering, where the first
// failing stage's bits are the node's reason word (node conditions ->
// GeneralPredicates -> taints -> memory pressure -> disk pressure); the
// int32 weighted score (Least/MostRequested, exact BalancedAllocation,
// NodeAffinity and TaintToleration normalized over the feasible nodes,
// PreferAvoidPods x 10000); selectHost (max score, round-robin pick of the
// (rr % ties)-th tie in node order when more than one node is feasible); the
// reason histogram when no node is feasible; the bind into the carry rows;
// rr += (feasible > 1).
//
// Design: one CTA of up to 1024 threads runs the whole chunk. Thread t owns
// a contiguous slice of the node axis, so the k-th tie in node order is
// found with a block exclusive scan of per-thread tie counts and a walk by
// the one thread whose slice holds it, and that thread also does the bind:
// every carry cell is read and written by its owner only. Per pod the block
// meets at about eight barriers (the feasible count / affinity max /
// intolerable max reduction, the score max, the tie scan, the end of the
// pod), plus two for the histogram when nothing fits. Signature rows are
// read straight from the [S, Npad] tables by the pod's ids.
//
// Bound: per pod the kernel reads 8 static, 7 carry and 6 table rows of
// Npad int32 values: at Npad 5120 about 430 KB a pod, 43 GB for 100k pods,
// about 13 ms at 3.35 TB/s. The whole state is about 0.4 MB and stays
// resident in the 50 MB L2, so neither device memory nor arithmetic is the
// limit: the chain of block barriers per pod, a strictly sequential
// dependency from one pod's bind to the next pod's filter, is. A cluster of
// CTAs splitting the node axis with the carry in shared memory is the next
// design; this one is the simple, exact first version.
//
// Arithmetic is int32 like the reference kernel: products wrap as two's
// complement and every division floors (JAX's //), so values that the plan's
// int32 bounds keep exact stay exact and masked lanes never trap.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPriority = 10;
constexpr int kAvoidWeight = 10000;

// pod column layout (tpusim_torch/kernels/fastscan.py POD_FIELDS); scalar
// requests follow at P_SCALAR
enum { P_RC, P_RM, P_RG, P_RE, P_NZC, P_NZM, P_ZERO, P_BE,
       P_SEL, P_TOL, P_AFF, P_AVOID, P_HOST, P_SCALAR };
// static rows
enum { S_CPU, S_MEM, S_GPU, S_EPH, S_ALLOWED, S_COND, S_MPR, S_DPR };
// carry rows; scalar rows follow at C_SCALAR
enum { C_CPU, C_MEM, C_GPU, C_EPH, C_NZC, C_NZM, C_PODS, C_SCALAR };
// reason bits (tpusim_torch/state.py)
constexpr int kBitPods = 4, kBitCpu = 5, kBitMem = 6, kBitGpu = 7,
              kBitEph = 8, kBitHost = 9, kBitSel = 10, kBitTaint = 11,
              kBitMemPressure = 12, kBitDiskPressure = 13, kFixedBits = 24;

struct Args {
  const int* pods;        // [k, pod_w]
  const int* statics;     // [8, npad]
  const int* sel;         // [Ssel, npad] selector_ok
  const int* tol;         // [Stol, npad] taint_ok
  const int* intol;       // [Stol, npad] intolerable
  const int* aff;         // [Saff, npad] aff_count
  const int* avoid;       // [Savoid, npad] avoid_score
  const int* host;        // [Shost, npad] host_ok
  int* carry;             // [7 + srows, npad], updated in place
  int* misc;              // [128]; rr at 0
  const int* alloc_scalar;  // [srows, npad]
  int* choices;           // [k]
  int* counts;            // [k, num_bits]
  int* adv;               // [k]
  int* scratch;           // [2, npad]: reason words, scores
  int k, pod_w, num_scalars, num_bits, npad, most_requested;
};

struct PodView {
  int rc, rm, rg, re, nzc, nzm;
  bool check_res, best_effort;
  const int *sel, *tol, *intol, *aff, *avoid, *host, *rs;
};

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// the first failing stage's reason bits; 0 = feasible
__device__ __forceinline__ int node_reason(const Args& a, const PodView& p,
                                           int i) {
  const int n = a.npad;
  const int* st = a.statics;
  const int* c = a.carry;
  const int cond = st[S_COND * n + i];
  if (cond != 0) return cond;
  int bits = (add32(c[C_PODS * n + i], 1) > st[S_ALLOWED * n + i])
                 ? 1 << kBitPods : 0;
  if (p.check_res) {
    if (st[S_CPU * n + i] < add32(c[C_CPU * n + i], p.rc)) bits |= 1 << kBitCpu;
    if (st[S_MEM * n + i] < add32(c[C_MEM * n + i], p.rm)) bits |= 1 << kBitMem;
    if (st[S_GPU * n + i] < add32(c[C_GPU * n + i], p.rg)) bits |= 1 << kBitGpu;
    if (st[S_EPH * n + i] < add32(c[C_EPH * n + i], p.re)) bits |= 1 << kBitEph;
    for (int s = 0; s < a.num_scalars; ++s) {
      if (a.alloc_scalar[s * n + i] < add32(c[(C_SCALAR + s) * n + i], p.rs[s]))
        bits |= 1 << (kFixedBits + s);
    }
  }
  if (p.host[i] == 0) bits |= 1 << kBitHost;
  if (p.sel[i] == 0) bits |= 1 << kBitSel;
  if (bits != 0) return bits;
  if (p.tol[i] == 0) return 1 << kBitTaint;
  if (p.best_effort && st[S_MPR * n + i] != 0) return 1 << kBitMemPressure;
  if (st[S_DPR * n + i] != 0) return 1 << kBitDiskPressure;
  return 0;
}

__device__ __forceinline__ int ratio(int req, int cap, bool most) {
  if (!(cap > 0 && req <= cap)) return 0;
  return floordiv(mul32(most ? req : cap - req, kMaxPriority), cap);
}

// weighted score of a feasible node
__device__ __forceinline__ int node_score(const Args& a, const PodView& p,
                                          int i, int aff_max, int intol_max) {
  const int n = a.npad;
  const int ac = a.statics[S_CPU * n + i];
  const int am = a.statics[S_MEM * n + i];
  const int tc = add32(a.carry[C_NZC * n + i], p.nzc);
  const int tm = add32(a.carry[C_NZM * n + i], p.nzm);
  const bool most = a.most_requested != 0;
  int s = floordiv(ratio(tc, ac, most) + ratio(tm, am, most), 2);
  if (!(ac == 0 || tc >= ac || am == 0 || tm >= am)) {
    // BalancedResourceAllocation, exact: |tc/ac - tm/am| over den = ac*am
    const int num = abs(mul32(tc, am) - mul32(tm, ac));
    const int den = mul32(ac, am);
    s += floordiv(mul32(kMaxPriority, den - num), den);
  }
  if (aff_max > 0) s += floordiv(mul32(kMaxPriority, p.aff[i]), aff_max);
  s += intol_max > 0
           ? kMaxPriority - floordiv(mul32(kMaxPriority, p.intol[i]), intol_max)
           : kMaxPriority;
  s += mul32(p.avoid[i], kAvoidWeight);
  return s;
}

// block-wide (sum, max, max); every thread gets the results
__device__ __forceinline__ void block_reduce3(int& s, int& m1, int& m2,
                                              int (*red)[3], int* bc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  s = __reduce_add_sync(kFull, s);
  m1 = __reduce_max_sync(kFull, m1);
  m2 = __reduce_max_sync(kFull, m2);
  if (lane == 0) {
    red[warp][0] = s;
    red[warp][1] = m1;
    red[warp][2] = m2;
  }
  __syncthreads();
  if (warp == 0) {
    int v0 = lane < nwarps ? red[lane][0] : 0;
    int v1 = lane < nwarps ? red[lane][1] : INT_MIN;
    int v2 = lane < nwarps ? red[lane][2] : INT_MIN;
    v0 = __reduce_add_sync(kFull, v0);
    v1 = __reduce_max_sync(kFull, v1);
    v2 = __reduce_max_sync(kFull, v2);
    if (lane == 0) {
      bc[0] = v0;
      bc[1] = v1;
      bc[2] = v2;
    }
  }
  __syncthreads();
  s = bc[0];
  m1 = bc[1];
  m2 = bc[2];
}

// block-wide exclusive prefix sum of v (thread order); *total gets the sum
__device__ __forceinline__ int block_excl_scan(int v, int* total, int* wscan,
                                               int* bc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wscan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? wscan[lane] : 0;
    int wx = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wx, o);
      if (lane >= o) wx += y;
    }
    wscan[lane] = wx - w;
    if (lane == 31) bc[0] = wx;
  }
  __syncthreads();
  *total = bc[0];
  return wscan[warp] + x - v;
}

__global__ void __launch_bounds__(1024) fastscan_kernel(Args a) {
  __shared__ int red[32][3];
  __shared__ int bc[3];
  __shared__ int wscan[32];
  __shared__ int hist[32];
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = a.npad;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int* reason_s = a.scratch;
  int* score_s = a.scratch + n;
  int rr = a.misc[0];

  for (int j = 0; j < a.k; ++j) {
    const int* pj = a.pods + (size_t)j * a.pod_w;
    PodView p;
    p.rc = pj[P_RC];
    p.rm = pj[P_RM];
    p.rg = pj[P_RG];
    p.re = pj[P_RE];
    p.nzc = pj[P_NZC];
    p.nzm = pj[P_NZM];
    p.check_res = pj[P_ZERO] == 0;
    p.best_effort = pj[P_BE] != 0;
    p.sel = a.sel + (size_t)pj[P_SEL] * n;
    p.tol = a.tol + (size_t)pj[P_TOL] * n;
    p.intol = a.intol + (size_t)pj[P_TOL] * n;
    p.aff = a.aff + (size_t)pj[P_AFF] * n;
    p.avoid = a.avoid + (size_t)pj[P_AVOID] * n;
    p.host = a.host + (size_t)pj[P_HOST] * n;
    p.rs = pj + P_SCALAR;

    // pass 1: reason words, feasible count, normalizer maxima
    int nf = 0, aff_max = 0, intol_max = 0;
    for (int i = lo; i < hi; ++i) {
      const int r = node_reason(a, p, i);
      reason_s[i] = r;
      if (r == 0) {
        ++nf;
        aff_max = max(aff_max, p.aff[i]);
        intol_max = max(intol_max, p.intol[i]);
      }
    }
    block_reduce3(nf, aff_max, intol_max, red, bc);

    if (nf > 0) {
      // pass 2: scores, and each thread's max with its multiplicity
      int lmax = -1, lcnt = 0;
      for (int i = lo; i < hi; ++i) {
        if (reason_s[i] != 0) continue;
        const int s = node_score(a, p, i, aff_max, intol_max);
        score_s[i] = s;
        if (s > lmax) {
          lmax = s;
          lcnt = 1;
        } else if (s == lmax) {
          ++lcnt;
        }
      }
      int dummy0 = 0, dummy1 = 0, gmax = lmax;
      block_reduce3(dummy0, gmax, dummy1, red, bc);
      const int tcnt = (lmax == gmax) ? lcnt : 0;
      int ties = 0;
      const int before = block_excl_scan(tcnt, &ties, wscan, bc);
      const int pick = nf > 1 ? rr % max(ties, 1) : 0;
      if (tcnt > 0 && before <= pick && pick < before + tcnt) {
        // this thread's slice holds the pick-th tie: find it and bind
        int seen = before;
        int choice = -1;
        for (int i = lo; i < hi; ++i) {
          if (reason_s[i] == 0 && score_s[i] == gmax) {
            if (seen == pick) {
              choice = i;
              break;
            }
            ++seen;
          }
        }
        int* c = a.carry;
        c[C_CPU * n + choice] += p.rc;
        c[C_MEM * n + choice] += p.rm;
        c[C_GPU * n + choice] += p.rg;
        c[C_EPH * n + choice] += p.re;
        c[C_NZC * n + choice] += p.nzc;
        c[C_NZM * n + choice] += p.nzm;
        c[C_PODS * n + choice] += 1;
        for (int s = 0; s < a.num_scalars; ++s)
          c[(C_SCALAR + s) * n + choice] += p.rs[s];
        a.choices[j] = choice;
      }
      if (tid < a.num_bits) a.counts[(size_t)j * a.num_bits + tid] = 0;
    } else {
      // reason histogram over the real bits (pad nodes carry bit 30 only)
      if (tid < 32) hist[tid] = 0;
      __syncthreads();
      for (int b = 0; b < a.num_bits; ++b) {
        int cnt = 0;
        for (int i = lo; i < hi; ++i) cnt += (reason_s[i] >> b) & 1;
        cnt = __reduce_add_sync(kFull, cnt);
        if (lane == 0 && cnt != 0) atomicAdd(&hist[b], cnt);
      }
      __syncthreads();
      if (tid < a.num_bits) a.counts[(size_t)j * a.num_bits + tid] = hist[tid];
      if (tid == 0) a.choices[j] = -1;
    }
    if (tid == 0) a.adv[j] = nf > 1 ? 1 : 0;
    rr += nf > 1 ? 1 : 0;
    __syncthreads();
  }
  if (tid == 0) a.misc[0] = rr;
}

}  // namespace

extern "C" int tpusim_fastscan_chunk(
    const int* pods, int k, int pod_w, const int* statics, const int* sel,
    const int* tol, const int* intol, const int* aff, const int* avoid,
    const int* host, int* carry, int* misc, const int* alloc_scalar,
    int num_scalars, int* choices, int* counts, int* adv, int* scratch,
    int num_bits, int npad, int most_requested, void* stream) {
  if (k <= 0) return 0;
  if (num_bits > 32 || npad <= 0 || npad % 32 != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.pods = pods;
  a.statics = statics;
  a.sel = sel;
  a.tol = tol;
  a.intol = intol;
  a.aff = aff;
  a.avoid = avoid;
  a.host = host;
  a.carry = carry;
  a.misc = misc;
  a.alloc_scalar = alloc_scalar;
  a.choices = choices;
  a.counts = counts;
  a.adv = adv;
  a.scratch = scratch;
  a.k = k;
  a.pod_w = pod_w;
  a.num_scalars = num_scalars;
  a.num_bits = num_bits;
  a.npad = npad;
  a.most_requested = most_requested;
  const int threads = npad < 1024 ? npad : 1024;
  fastscan_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
