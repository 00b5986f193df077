// Fused fast scan for Hopper (sm_90a): the group-free variant, the
// pod-group variant, the inter-pod variant and the policy variant.
//
// Replaces the TPU kernel tpusim/jaxe/fastscan.py::_make_kernel (the
// Pallas kernel behind fast_scan):
//   Variant 1, group-free: no pod groups, no inter-pod terms, no MaxPD
//     volumes, no policy residue; up to 6 scalar resource axes and Least-
//     or MostRequested;
//   Variants 2 and 4, pod groups: Variant 1 plus the [Gpad, Npad] presence
//     carry (PodFitsHostPorts inside GeneralPredicates, NoDiskConflict,
//     NoVolumeZoneConflict, SelectorSpreadPriority with its node/zone blend,
//     presence[gid][choice] += 1 on bind) and the MaxPD used-volume carry
//     (Max{EBS,GCEPD,AzureDisk}VolumeCount, used_vols[v][choice] = 1 on
//     bind);
//   Variant 3, inter-pod (anti)affinity: Variants 2 and 4 plus
//     MatchInterPodAffinity (the last filter stage), InterPodAffinityPriority
//     and the [Gpad*K, Dpad] presence_dom carry (pods of group g per domain
//     of topology key k, row g*K + k; presence_dom[gid*K + k][dom_k(choice)]
//     += 1 on bind). K <= 4 keys, D <= 64 domains, at most 4 terms of each
//     kind are compile-time maxima; the plan's own values, its per-group
//     packed rows and its exist-side tables are runtime arguments, so one
//     build serves every plan;
//   Variant 5, the policy residue: a scheduler Policy on top of Variants 2-4
//     (and 3 when the plan has inter-pod terms). The policy's predicate
//     gating is a stage program, a short list of (opcode, operand) pairs in
//     the order kube-scheduler evaluates them, which node_reason interprets
//     per node from shared memory: the Pallas kernel's stages plus label-
//     presence rows, ServiceAffinity entries and the PodFitsPorts alias at
//     the ordering or tail slot they were registered under, and the
//     NoExecute-only taint table. Every score weight (the eight components,
//     ImageLocality, each ServiceAntiAffinity entry) is a runtime argument
//     too, beside the NodeLabel priority row and the image-score table, so
//     one build serves every policy. alwaysCheckAllPredicates (count mode)
//     makes the histogram add every failing stage's reasons.
//
// What it computes, for each pod of a chunk in order (kube-scheduler's
// scheduleOne): the filter stages in predicatesOrdering, where the first
// failing stage's bits are the node's reason word (node conditions ->
// GeneralPredicates with host ports -> NoDiskConflict -> taints -> MaxPD ->
// NoVolumeZoneConflict -> memory pressure -> disk pressure ->
// MatchInterPodAffinity); the int32 weighted score (Least/MostRequested,
// exact BalancedAllocation, NodeAffinity and TaintToleration normalized
// over the feasible nodes, PreferAvoidPods x 10000, SelectorSpread,
// InterPodAffinity normalized by the feasible min and max); selectHost (max score,
// round-robin pick of the (rr % ties)-th tie in node order when more than
// one node is feasible); the reason histogram when no node is feasible; the
// bind into the carry rows; rr += (feasible > 1).
//
// Design: one thread-block cluster of up to 16 CTAs runs the whole chunk,
// one CTA an SM (launched with cudaLaunchKernelEx and a cluster dimension;
// 16 is a non-portable size). CTA r owns a contiguous slab of the node axis
// and its threads own contiguous runs of the slab (one node a thread at
// Npad 5120), so node order is (rank, thread) order. Every carry cell,
// presence and used-volume cells included, is read and written only by the
// thread that owns its node, so node state needs no cross-SM coherence and
// binds need no atomics; the per-node scratch (reason words, scores, spread,
// inter-pod and ServiceAntiAffinity counts) lives in the CTA's shared memory.
// Per pod the CTAs meet at two cluster barriers, and every exchange is a
// push: before a barrier each CTA reduces its values in shared memory and
// writes them into its rank's slot in every CTA (distributed shared memory),
// so after it every read is local. Before the first, the feasible count,
// normalizer maxima, zone sums and ServiceAntiAffinity sums; each CTA then
// reduces the slots in rank order, so all hold the same totals. Before the
// second, each CTA's (score max, count at max); every warp then finds the
// max, the ties and the ties in the CTAs and warps before it, and the one
// thread whose run holds the (rr % ties)-th tie walks to it and binds. When
// nothing fits, the CTAs push their histograms to rank 0 instead. A slot is
// written again only behind the next barrier, after every read of it. A
// third barrier follows only a bind that another CTA reads: presence_dom or
// a new ServiceAffinity lock, of which every CTA keeps a copy in shared
// memory that the binding thread updates in every CTA (L1 is not coherent
// across SMs, so no CTA reads a global cell another writes). rr is a
// register every thread updates alike. Signature rows, the vol-zone row and
// the MaxPD volume row are read straight from their tables by the pod's
// ids.
//
// The pod-group operands are shaped for a CTA, not for the TPU's (8, 128)
// tiles: a pod's port, disk and spread group sets arrive as bit words in its
// pod row, and a thread loops over the set bits only, reading
// presence[g][i] for its nodes. Zones are one zone-id row; the per-zone sums
// of feasible spread counts accumulate per thread in registers during pass
// 1 and meet in the CTA's values in shared memory with one atomic per zone per
// warp, and the node maximum and "any feasible zoned node" ride the pass-1
// exchange, so spreading adds no barrier. MaxPD's volume types and limits
// are arguments; a node's count is a loop over the volume ids (at most 32 by
// the plan's budget), taken only for pods that mount a counted volume.
//
// The inter-pod variant needs, before any node's filter, per-domain sums
// over the whole node axis. It takes them from the presence_dom carry
// instead of a node pass per term: the domain-d sum of the pods matching an
// own term is the sum of presence_dom[g*K + key][d] over the groups g the
// term matches. So one phase per pod, block-parallel over cells and run
// again in every CTA of the cluster, fills shared memory (about 5 KB): seg[term][d] for the pod's own required
// affinity, anti-affinity and preferred terms (one cell per (term, domain),
// at most 12 x 64), the existing pods' anti-affinity sums Bk[k][d] and
// weighted sums Wk[k][d] (one cell per (key, domain), at most 4 x 64, each
// looping over the other groups' terms that match this pod), each affinity
// term's total (a matching pod exists anywhere: the sum over all domains,
// domain 0 included, by a shared atomic per cell), the "fail everywhere"
// flag of empty-key anti-affinity terms of groups with any pod, the term
// keys and flags, and the groups each own term matches as bit words (for
// hostname terms, which look at the node's own matched pods). Two block
// barriers frame the phase. The stage and the counts row then ride pass 1
// per node: shared lookups at the node's domain per key, and the counts'
// min and max over the feasible nodes ride the pass-1 exchange. The owning
// thread binds presence_dom next to presence with an atomic add in L2, and
// the third cluster barrier orders it before every CTA's next phase. Pad
// nodes lie in domain 0 with zero presence and never add to a real domain's
// sum.
//
// The policy variant keeps the same passes. Pass 1 runs the stage program;
// a node's reason word is its first failing stage's bits, nonzero exactly
// when some stage fails, so it decides feasibility in count mode too, and
// when no node fits in count mode the histogram pass runs the program again
// over the thread's nodes and adds every failing stage's bits (per-thread
// counters, a warp reduction, one shared atomic per bit). ServiceAntiAffinity
// needs, per entry and label domain, the feasible nodes' sum of the pods in
// the pod's first service: pass 1 stores each feasible node's count and
// adds the total, then walks its slice once per entry into per-domain
// registers that meet in the CTA's values with one atomic per domain
// per warp, so the entries add no barrier; pass 2 normalizes. ServiceAffinity
// reads the pod's lock (the first matching pod's node) from the CTA's copy of
// misc lanes 1.. at its first-service signature, and the locked node's label
// values by direct loads; the thread that binds writes a new lock into every
// CTA's copy, the third cluster barrier orders that write before the next
// pod reads it, and rank 0 writes the lanes back at the end.
//
// Bound: per pod the kernel reads 8 static, 7 carry and 6 table rows of
// Npad int32 values, plus the presence rows of the pod's groups: at Npad
// 5120 about 430 KB a pod, 43 GB for 100k pods, about 13 ms at 3.35 TB/s.
// The whole state is under 1 MB and stays resident in the 50 MB L2, so
// neither device memory nor arithmetic is the limit: the chain from one
// pod's bind to the next pod's filter is. Splitting the node axis over the
// cluster cut the node loop to one node a thread; what is left (PERF.md,
// the cluster-size sweep) is a per-pod chain that does not shrink with more
// CTAs: the pod's setup and first loads of its signature rows, two or three
// cluster barriers and the exchanges through distributed shared memory.
//
// Arithmetic is int32 like the reference kernel: products wrap as two's
// complement and every division floors (JAX's //), so values that the plan's
// int32 bounds keep exact stay exact and masked lanes never trap.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPriority = 10;
constexpr int kAvoidWeight = 10000;
constexpr int kMaxZones = 16;   // tpusim_torch/kernels/fastscan.py MAX_ZONES
// the geometry (kernels/fastscan.py MAX_THREADS, CLUSTER_SIZES,
// SCRATCH_ROWS, MISC_WIDTH): threads a CTA, CTAs a cluster, per-node
// scratch rows, misc lanes
constexpr int kMaxThreads = 512, kMaxCluster = 16, kScratchRows = 5,
              kMiscWidth = 128;

constexpr int kMaxWarps = kMaxThreads / 32;
// a CTA's values for one pod, each a sum or a max from 0: the pass-1
// values (feasible count, then maxima), the spread zone sums, the
// ServiceAntiAffinity total and per-(entry, domain) sums; then the reason
// histogram
enum { R_RED = 0, R_ZSUM = 8, R_SAAT = R_ZSUM + kMaxZones, R_SAAS = R_SAAT + 1,
       R_HIST = R_SAAS + 8 * kMaxZones, kAccWords = R_HIST + 32 };

// pod column layout (tpusim_torch/kernels/fastscan.py POD_FIELDS); scalar
// requests follow at P_SCALAR, then the group id and the group-set words
enum { P_RC, P_RM, P_RG, P_RE, P_NZC, P_NZM, P_ZERO, P_BE,
       P_SEL, P_TOL, P_AFF, P_AVOID, P_HOST, P_SCALAR };
// static rows
enum { S_CPU, S_MEM, S_GPU, S_EPH, S_ALLOWED, S_COND, S_MPR, S_DPR };
// carry rows; scalar rows follow at C_SCALAR
enum { C_CPU, C_MEM, C_GPU, C_EPH, C_NZC, C_NZM, C_PODS, C_SCALAR };
// group feature flags (kernels/fastscan.py F_*)
enum { F_PORTS = 1, F_DISK = 2, F_SPREAD = 4, F_VOL_ZONE = 8 };
// reason bits (tpusim_torch/state.py)
constexpr int kBitPods = 4, kBitCpu = 5, kBitMem = 6, kBitGpu = 7,
              kBitEph = 8, kBitHost = 9, kBitSel = 10, kBitTaint = 11,
              kBitMemPressure = 12, kBitDiskPressure = 13, kBitPorts = 14,
              kBitDisk = 19, kBitMaxVols = 20, kBitVolZone = 21,
              kFixedBits = 24;
constexpr int kBitIpUmbrella = 15, kBitExistAnti = 16, kBitAffRules = 17,
              kBitAntiRules = 18;
constexpr int kBitUnsched = 3, kBitLabel = 22, kBitSa = 23, kBitPad = 30;
// stage opcodes (kernels/fastscan.py OP_*)
enum { OP_COND, OP_UNSCHED, OP_GENERAL, OP_HOST, OP_PORTS, OP_SEL, OP_RES,
       OP_DISK, OP_TAINT, OP_NOEXEC, OP_MAXPD, OP_VOL_ZONE, OP_MEM_PRESSURE,
       OP_DISK_PRESSURE, OP_INTERPOD, OP_LABEL, OP_SA };
// the policy header (kernels/fastscan.py H_*, MAX_STAGES, MAX_SAA)
constexpr int kMaxStages = 64, kMaxSaa = 8;
enum { H_STAGES = 0, H_WEIGHTS = 1, H_W_IMAGE = 9, H_N_SAA = 10,
       H_SAA_DOMS = 11, H_COUNT_MODE = 12, H_SA_LOCKS = 13, H_FD = 14,
       H_LA = 15, H_SAA_W = 16, H_PROGRAM = H_SAA_W + kMaxSaa,
       kPolWords = H_PROGRAM + 2 * kMaxStages };
// the eight component weights (config.policy_weights order)
enum { W_LEAST, W_MOST, W_BALANCED, W_AFF, W_TAINT, W_AVOID, W_SPREAD,
       W_INTERPOD };
// inter-pod maxima (kernels/fastscan.py MAX_TOPO_KEYS, MAX_TOPO_DOMS,
// MAX_TERMS, MAX_IP_GROUPS)
constexpr int kMaxKeys = 4, kMaxDoms = 64, kMaxTerms = 4,
              kMaxOwn = 3 * kMaxTerms, kMaxIpWords = 4;
// InterPodAffinityPriority's weight without a policy
constexpr int kInterpodWeight = 1;
// own-term flags
enum { T_VALID = 1, T_HOST = 2, T_SELF = 4, T_UNPL = 8 };

// offsets into a group's packed inter-pod row (fastplan.IpLayout) and into
// the exist-side tables (kernels/fastscan.py EXIST_TABLES)
struct IpLayout {
  int aff_match, aff_key, aff_valid, aff_empty, aff_host, aff_self, aff_unpl,
      aff_err, anti_match, anti_key, anti_valid, anti_host, anti_err,
      pref_match, pref_key, pref_w, ex_anti, ex_pref, ex_aff, width;
  int e_anti_key, e_anti_mask, e_anti_empty, e_pref_key, e_pref_w, e_aff_key,
      e_aff_mask;
};

IpLayout ip_layout(int ta, int tb, int tp, int gpad) {
  IpLayout l;
  int off = 0;
  auto take = [&off](int n) { const int at = off; off += n; return at; };
  l.aff_match = take(ta * gpad);
  l.aff_key = take(ta);
  l.aff_valid = take(ta);
  l.aff_empty = take(ta);
  l.aff_host = take(ta);
  l.aff_self = take(ta);
  l.aff_unpl = take(ta);
  l.aff_err = take(1);
  l.anti_match = take(tb * gpad);
  l.anti_key = take(tb);
  l.anti_valid = take(tb);
  l.anti_host = take(tb);
  l.anti_err = take(1);
  l.pref_match = take(tp * gpad);
  l.pref_key = take(tp);
  l.pref_w = take(tp);
  l.ex_anti = take(gpad * tb);
  l.ex_pref = take(gpad * tp);
  l.ex_aff = take(gpad * ta);
  l.width = off;
  off = 0;
  l.e_anti_key = take(gpad * tb);
  l.e_anti_mask = take(gpad * tb);
  l.e_anti_empty = take(gpad * tb);
  l.e_pref_key = take(gpad * tp);
  l.e_pref_w = take(gpad * tp);
  l.e_aff_key = take(gpad * ta);
  l.e_aff_mask = take(gpad * ta);
  return l;
}

struct Args {
  const int* pods;        // [k, pod_w]
  const int* statics;     // [8, npad]
  const int* sel;         // [Ssel, npad] selector_ok
  const int* tol;         // [Stol, npad] taint_ok
  const int* intol;       // [Stol, npad] intolerable
  const int* aff;         // [Saff, npad] aff_count
  const int* avoid;       // [Savoid, npad] avoid_score
  const int* host;        // [Shost, npad] host_ok
  int* carry;             // [7 + srows + gpad + vpad, npad], updated in place
  int* misc;              // [128]; rr at 0
  const int* alloc_scalar;  // [srows, npad]
  int* choices;           // [k]
  int* counts;            // [k, num_bits]
  int* adv;               // [k]
  int* scratch;           // [cluster, 5, slab] per-node scratch, or null
                          // when it lives in dynamic shared memory
  int scratch_smem;       // the scratch is in dynamic shared memory
  int k, pod_w, num_scalars, num_bits, npad, most_requested;
  // pod groups (the group variant only)
  int gpad;               // presence rows; words = ceil(gpad / 32)
  int words;
  int pres_row;           // first presence row of the carry
  int flags;              // F_*
  const int* zone_id;     // [npad] zone domain, 0 = none (spread)
  int n_zones;
  const int* zone_ok;     // [G, npad] NoVolumeZoneConflict pass, by gid
  const int* vol_tbl;     // [G, vol_w] MaxPD volume mask, by gid
  int vol_w;
  const int* vol_type;    // [n_vols, 3] (EBS, GCE PD, AzureDisk)
  int n_vols;
  int uv_row;             // first used-volume row of the carry
  int limit[3];
  // inter-pod (the inter-pod variant only)
  int k_keys, d_doms, ta, tb, tp, hard_weight;
  const int* topo;        // [>= k_keys, npad] domain id per key and node
  const int* ipod;        // [gpad, wip] packed rows, by gid
  int wip;
  const int* exist;       // the exist-side tables
  int* pd;                // [gpad * k_keys, dpad] presence_dom, in place
  int dpad;
  IpLayout lay;
  // policy (the policy variant only)
  const int* pol;         // [kPolWords] the header and stage program
  const int* label_tbl;   // [Lpad, npad] label-presence pass rows
  const int* label_prio;  // [npad] NodeLabel priorities, pre-weighted
  const int* image_tbl;   // [Si, npad] ImageLocality scores, by image set
  const int* noexec_tbl;  // [Ctol, npad] NoExecute tolerance, by tol_id
  const int* saa_dom;     // [E, npad] ServiceAntiAffinity label domains
  const int* sa_val;      // [La, npad] ServiceAffinity label values
  int pol_col;            // first policy column of a pod row
};

// what the policy variant keeps in shared memory
struct PolShared {
  int h[kPolWords];                 // the header and stage program
};

template <bool kPolicy>
struct PolSlot {
  PolShared s;
};
template <>
struct PolSlot<false> {};

// what the inter-pod phase leaves in shared memory for one pod
struct IpShared {
  int seg[kMaxOwn][kMaxDoms];  // own term t: per-domain sums of matched pods
  int bk[kMaxKeys][kMaxDoms];  // existing pods' anti-affinity sums
  int wk[kMaxKeys][kMaxDoms];  // existing pods' weighted preference sums
  int tot[kMaxTerms];          // affinity term t: matched pods anywhere
  unsigned mw[kMaxOwn][kMaxIpWords];  // groups own term t matches
  int key[kMaxOwn];            // own term t's topology key
  int flag[kMaxOwn];           // T_* flags (affinity and anti-affinity)
  int w[kMaxTerms];            // preferred term weights
  int aff_err, anti_err, fail_all;
};

template <bool kInterpod>
struct IpSlot {
  IpShared s;
};
template <>
struct IpSlot<false> {};

struct PodView {
  int rc, rm, rg, re, nzc, nzm;
  bool check_res, best_effort;
  const int *sel, *tol, *intol, *aff, *avoid, *host, *rs;
  // group variant
  int gid;
  const int *port_w, *disk_w, *ss_w;   // group-set bit words
  const int* zone_ok;                  // my vol-zone row
  const int* vols;                     // my MaxPD volume mask row
  int my_typed[3];                     // my volumes of each MaxPD type
  bool maxpd;                          // I mount a counted volume
  // policy variant
  const int* saa_w;    // my first service's group set, bit words
  const int* img;      // my ImageLocality row, or null
  const int* noexec;   // my NoExecute tolerance row, or null
  const int* pins;     // my ServiceAffinity pins [la]
  const int* match;    // my lock match flags [fd]
  int lock;            // my first-service signature's lock (< 0: none)
};

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// any pod of the groups set in `words` on node i
__device__ __forceinline__ bool any_present(const Args& a, const int* words,
                                            int i) {
  for (int w = 0; w < a.words; ++w) {
    unsigned bits = (unsigned)words[w];
    while (bits) {
      const int g = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      if (a.carry[(size_t)(a.pres_row + g) * a.npad + i] > 0) return true;
    }
  }
  return false;
}

// pods on node i of the groups my services select
__device__ __forceinline__ int spread_count(const Args& a, const PodView& p,
                                            int i) {
  int c = 0;
  for (int w = 0; w < a.words; ++w) {
    unsigned bits = (unsigned)p.ss_w[w];
    while (bits) {
      const int g = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      c = add32(c, a.carry[(size_t)(a.pres_row + g) * a.npad + i]);
    }
  }
  return c;
}

// Max{EBS,GCEPD,AzureDisk}VolumeCount on node i: the unique counted volume
// ids there, mine included, over a type's limit, for a counted type
// (bit t of `types`) I mount
__device__ __forceinline__ bool maxpd_fails(const Args& a, const PodView& p,
                                            int i, int types) {
  int cnt[3] = {0, 0, 0};
  for (int v = 0; v < a.n_vols; ++v) {
    const int used = p.vols[v] != 0
                         ? 1 : a.carry[(size_t)(a.uv_row + v) * a.npad + i];
    const int* ty = a.vol_type + 3 * v;
    cnt[0] += ty[0] ? used : 0;
    cnt[1] += ty[1] ? used : 0;
    cnt[2] += ty[2] ? used : 0;
  }
  for (int t = 0; t < 3; ++t)
    if (((types >> t) & 1) && p.my_typed[t] > 0 && cnt[t] > a.limit[t])
      return true;
  return false;
}

// where own term t's match lanes and topology key sit in a packed row
// (terms 0..ta-1 affinity, then anti-affinity, then preferred)
__device__ __forceinline__ void own_term_at(const Args& a, int t,
                                            int* match_off, int* key_off) {
  const IpLayout& l = a.lay;
  if (t < a.ta) {
    *match_off = l.aff_match + t * a.gpad;
    *key_off = l.aff_key + t;
  } else if (t < a.ta + a.tb) {
    *match_off = l.anti_match + (t - a.ta) * a.gpad;
    *key_off = l.anti_key + (t - a.ta);
  } else {
    *match_off = l.pref_match + (t - a.ta - a.tb) * a.gpad;
    *key_off = l.pref_key + (t - a.ta - a.tb);
  }
}

// The inter-pod phase of one pod (group gid): fills `s`, block-parallel
// over cells, from the CTA's presence_dom replica pd_s. tot and fail_all
// must be 0 on entry; a barrier must follow.
__device__ void interpod_phase(const Args& a, const int* pd_s, int gid,
                               IpShared& s) {
  const IpLayout& l = a.lay;
  const int* r = a.ipod + (size_t)gid * a.wip;
  const int* ex = a.exist;
  const int gpad = a.gpad, nk = a.k_keys, nd = a.d_doms;
  const int ta = a.ta, tb = a.tb, tp = a.tp, nown = ta + tb + tp;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int t = tid; t < nown; t += nt) {
    int match_off, key_off, flag = 0;
    own_term_at(a, t, &match_off, &key_off);
    if (t < ta) {
      flag = (r[l.aff_valid + t] ? T_VALID : 0) |
             (r[l.aff_host + t] ? T_HOST : 0) |
             (r[l.aff_self + t] ? T_SELF : 0) |
             (r[l.aff_unpl + t] ? T_UNPL : 0);
    } else if (t < ta + tb) {
      flag = (r[l.anti_valid + t - ta] ? T_VALID : 0) |
             (r[l.anti_host + t - ta] ? T_HOST : 0);
    } else {
      s.w[t - ta - tb] = r[l.pref_w + t - ta - tb];
    }
    s.key[t] = r[key_off];
    s.flag[t] = flag;
  }
  if (tid == 0) {
    s.aff_err = r[l.aff_err];
    s.anti_err = r[l.anti_err];
  }
  // the groups each own term matches, as bit words
  for (int c = tid; c < nown * a.words; c += nt) {
    const int t = c / a.words, w = c % a.words;
    int match_off, key_off;
    own_term_at(a, t, &match_off, &key_off);
    unsigned bits = 0;
    for (int b = 0; b < 32; ++b) {
      const int g = w * 32 + b;
      if (g < gpad && r[match_off + g] != 0) bits |= 1u << b;
    }
    s.mw[t][w] = bits;
  }
  // own terms: per-domain sums of the matched pods, from presence_dom
  for (int c = tid; c < nown * nd; c += nt) {
    const int t = c / nd, d = c % nd;
    int match_off, key_off;
    own_term_at(a, t, &match_off, &key_off);
    const int key = r[key_off];
    int sum = 0;
    for (int g = 0; g < gpad; ++g)
      if (r[match_off + g] != 0)
        sum = add32(sum, pd_s[(g * nk + key) * a.dpad + d]);
    s.seg[t][d] = sum;
    if (t < ta && sum != 0) atomicAdd(&s.tot[t], sum);
  }
  // the existing pods' terms that match me, per key and domain
  for (int c = tid; c < nk * nd; c += nt) {
    const int k = c / nd, d = c % nd;
    int b = 0, wsum = 0;
    for (int g = 0; g < gpad; ++g) {
      const int v = pd_s[(g * nk + k) * a.dpad + d];
      for (int t = 0; t < tb; ++t) {
        const int idx = g * tb + t;
        if (r[l.ex_anti + idx] && ex[l.e_anti_mask + idx] &&
            ex[l.e_anti_key + idx] == k)
          b = add32(b, v);
      }
      for (int t = 0; t < tp; ++t) {
        const int idx = g * tp + t;
        const int ws = ex[l.e_pref_w + idx];
        if (ws != 0 && r[l.ex_pref + idx] && ex[l.e_pref_key + idx] == k)
          wsum = add32(wsum, mul32(v, ws));
      }
      for (int t = 0; t < ta; ++t) {
        const int idx = g * ta + t;
        if (r[l.ex_aff + idx] && ex[l.e_aff_mask + idx] &&
            ex[l.e_aff_key + idx] == k)
          wsum = add32(wsum, mul32(v, a.hard_weight));
      }
    }
    s.bk[k][d] = b;
    s.wk[k][d] = wsum;
  }
  // an existing empty-key anti-affinity term that matches me fails me on
  // every node once its group has a pod anywhere
  for (int c = tid; c < gpad * tb; c += nt) {
    if (!ex[l.e_anti_empty + c] || !r[l.ex_anti + c]) continue;
    const int g = c / tb;
    int pods = 0;
    for (int d = 0; d < nd; ++d)
      pods = add32(pods, pd_s[g * nk * a.dpad + d]);
    if (pods > 0) atomicOr(&s.fail_all, 1);
  }
}

// pods of the groups own term t matches, on node i
__device__ __forceinline__ int term_on_node(const Args& a, const IpShared& s,
                                            int t, int i) {
  int c = 0;
  for (int w = 0; w < a.words; ++w) {
    unsigned bits = s.mw[t][w];
    while (bits) {
      const int g = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      c = add32(c, a.carry[(size_t)(a.pres_row + g) * a.npad + i]);
    }
  }
  return c;
}

// MatchInterPodAffinity (predicates.go:1125-1450) on node i: 0, or the
// umbrella bit plus existing-anti, affinity or anti-affinity, in that order
__device__ __forceinline__ int interpod_reason(const Args& a,
                                               const IpShared& s, int i) {
  const int n = a.npad;
  bool aff_fail = s.aff_err != 0, anti_fail = s.anti_err != 0;
  for (int t = 0; t < a.ta; ++t) {
    const int f = s.flag[t];
    if (!(f & T_VALID)) continue;
    const int dom = a.topo[(size_t)s.key[t] * n + i];
    bool matches, exists;
    if (f & T_HOST) {
      // hostname terms look at this node's pods only
      const bool on = term_on_node(a, s, t, i) > 0;
      matches = dom > 0 && on;
      exists = on;
    } else {
      matches = dom > 0 && s.seg[t][dom] > 0;
      exists = s.tot[t] > 0 || (f & T_UNPL);
    }
    if (!(matches || (!exists && (f & T_SELF)))) aff_fail = true;
  }
  for (int t = a.ta; t < a.ta + a.tb; ++t) {
    const int f = s.flag[t];
    if (!(f & T_VALID)) continue;
    const int dom = a.topo[(size_t)s.key[t] * n + i];
    const bool hit = (f & T_HOST) ? term_on_node(a, s, t, i) > 0
                                  : s.seg[t][dom] > 0;
    if (dom > 0 && hit) anti_fail = true;
  }
  bool exist_fail = s.fail_all != 0;
  for (int k = 0; k < a.k_keys; ++k) {
    const int dom = a.topo[(size_t)k * n + i];
    if (dom >= 1 && s.bk[k][dom] > 0) exist_fail = true;
  }
  if (!(exist_fail || aff_fail || anti_fail)) return 0;
  return (1 << kBitIpUmbrella) |
         (exist_fail ? 1 << kBitExistAnti
                     : aff_fail ? 1 << kBitAffRules : 1 << kBitAntiRules);
}

// InterPodAffinityPriority's count on node i (interpod_affinity.go): my
// preferred terms over the pods present, the existing pods' preferred and
// required affinity terms (x the hard weight) over me
__device__ __forceinline__ int interpod_count(const Args& a,
                                              const IpShared& s, int i) {
  const int n = a.npad;
  int c = 0;
  for (int t = 0; t < a.tp; ++t) {
    const int tt = a.ta + a.tb + t;
    if (s.w[t] == 0) continue;
    const int dom = a.topo[(size_t)s.key[tt] * n + i];
    if (dom > 0) c = add32(c, mul32(s.seg[tt][dom], s.w[t]));
  }
  for (int k = 0; k < a.k_keys; ++k) {
    const int dom = a.topo[(size_t)k * n + i];
    if (dom >= 1) c = add32(c, s.wk[k][dom]);
  }
  return c;
}

// PodFitsResources on node i: the pod count, and unless the pod requests
// nothing, each resource axis
__device__ __forceinline__ int res_bits(const Args& a, const PodView& p,
                                        int i) {
  const int n = a.npad;
  const int* st = a.statics;
  const int* c = a.carry;
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
  return bits;
}

// CheckServiceAffinity for one entry (first label | labels << 16) on node i:
// my own nodeSelector pins, else the locked node's values (a label the
// locked node lacks pins nothing)
__device__ __forceinline__ bool sa_fails(const Args& a, const PodView& p,
                                         int i, int entry) {
  const int first = entry & 0xffff, last = first + (entry >> 16);
  bool ok_own = true, ok_lock = true;
  for (int l = first; l < last; ++l) {
    const int* val = a.sa_val + (size_t)l * a.npad;
    const int v = val[i];
    if (p.pins[l] != 0) {
      if (v != p.pins[l]) ok_own = false;
    } else if (p.lock >= 0) {
      const int locked = val[p.lock];
      if (locked > 0 && v != locked) ok_lock = false;
    }
  }
  return !(ok_own && (ok_lock || p.lock < 0));
}

// one stage of a stage program on node i: its reason bits, 0 = passes
template <bool kInterpod>
__device__ __forceinline__ int stage_bits(const Args& a, const PodView& p,
                                          int i, int op, int operand,
                                          const IpShared* ips) {
  const int n = a.npad;
  const int* st = a.statics;
  switch (op) {
    case OP_COND:
      return st[S_COND * n + i];
    case OP_UNSCHED:
      return st[S_COND * n + i] & (1 << kBitUnsched);
    case OP_GENERAL: {
      int bits = res_bits(a, p, i);
      if (p.host[i] == 0) bits |= 1 << kBitHost;
      if (p.sel[i] == 0) bits |= 1 << kBitSel;
      if ((a.flags & F_PORTS) && any_present(a, p.port_w, i))
        bits |= 1 << kBitPorts;
      return bits;
    }
    case OP_HOST:
      return p.host[i] == 0 ? 1 << kBitHost : 0;
    case OP_PORTS:
      return any_present(a, p.port_w, i) ? 1 << kBitPorts : 0;
    case OP_SEL:
      return p.sel[i] == 0 ? 1 << kBitSel : 0;
    case OP_RES:
      return res_bits(a, p, i);
    case OP_DISK:
      return any_present(a, p.disk_w, i) ? 1 << kBitDisk : 0;
    case OP_TAINT:
      return p.tol[i] == 0 ? 1 << kBitTaint : 0;
    case OP_NOEXEC:
      return p.noexec[i] == 0 ? 1 << kBitTaint : 0;
    case OP_MAXPD:
      return p.maxpd && maxpd_fails(a, p, i, operand) ? 1 << kBitMaxVols : 0;
    case OP_VOL_ZONE:
      return p.zone_ok[i] == 0 ? 1 << kBitVolZone : 0;
    case OP_MEM_PRESSURE:
      return p.best_effort && st[S_MPR * n + i] != 0 ? 1 << kBitMemPressure
                                                     : 0;
    case OP_DISK_PRESSURE:
      return st[S_DPR * n + i] != 0 ? 1 << kBitDiskPressure : 0;
    case OP_INTERPOD:
      if constexpr (kInterpod) return interpod_reason(a, *ips, i);
      return 0;
    case OP_LABEL:
      return a.label_tbl[(size_t)operand * n + i] == 0 ? 1 << kBitLabel : 0;
    case OP_SA:
      return sa_fails(a, p, i, operand) ? 1 << kBitSa : 0;
  }
  return 0;
}

// the first failing stage's reason bits; 0 = feasible. The policy variant
// interprets the program in `pol`; the others run the provider's stages
template <bool kGroups, bool kInterpod, bool kPolicy>
__device__ __forceinline__ int node_reason(const Args& a, const PodView& p,
                                           int i, const IpShared* ips,
                                           const PolShared* pol) {
  if constexpr (kPolicy) {
    const int* prog = pol->h + H_PROGRAM;
    for (int t = 0; t < pol->h[H_STAGES]; ++t) {
      const int bits =
          stage_bits<kInterpod>(a, p, i, prog[2 * t], prog[2 * t + 1], ips);
      if (bits != 0) return bits;
    }
    return 0;
  }
  const int n = a.npad;
  const int* st = a.statics;
  const int cond = st[S_COND * n + i];
  if (cond != 0) return cond;
  int bits = res_bits(a, p, i);
  if (p.host[i] == 0) bits |= 1 << kBitHost;
  if (p.sel[i] == 0) bits |= 1 << kBitSel;
  if (kGroups && (a.flags & F_PORTS) && any_present(a, p.port_w, i))
    bits |= 1 << kBitPorts;
  if (bits != 0) return bits;
  if (kGroups && (a.flags & F_DISK) && any_present(a, p.disk_w, i))
    return 1 << kBitDisk;
  if (p.tol[i] == 0) return 1 << kBitTaint;
  if (kGroups && p.maxpd && maxpd_fails(a, p, i, 7)) return 1 << kBitMaxVols;
  if (kGroups && (a.flags & F_VOL_ZONE) && p.zone_ok[i] == 0)
    return 1 << kBitVolZone;
  if (p.best_effort && st[S_MPR * n + i] != 0) return 1 << kBitMemPressure;
  if (st[S_DPR * n + i] != 0) return 1 << kBitDiskPressure;
  if constexpr (kInterpod) return interpod_reason(a, *ips, i);
  return 0;
}

// alwaysCheckAllPredicates' histogram over this thread's nodes: every
// failing stage adds its reasons (pad nodes add nothing), summed per bit
// into `hist` by a warp reduction and one shared atomic per bit
template <bool kInterpod>
__device__ void count_mode_hist(const Args& a, const PodView& p, int lo,
                                int hi, const IpShared* ips,
                                const PolShared& pol, int* hist) {
  int cnt[32] = {};
  const int* prog = pol.h + H_PROGRAM;
  for (int i = lo; i < hi; ++i) {
    if ((a.statics[S_COND * a.npad + i] >> kBitPad) & 1) continue;
    for (int t = 0; t < pol.h[H_STAGES]; ++t) {
      unsigned bits = (unsigned)stage_bits<kInterpod>(a, p, i, prog[2 * t],
                                                      prog[2 * t + 1], ips);
      while (bits) {
        ++cnt[__ffs(bits) - 1];
        bits &= bits - 1;
      }
    }
  }
  for (int b = 0; b < a.num_bits; ++b) {
    const int c = __reduce_add_sync(kFull, cnt[b]);
    if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(&hist[b], c);
  }
}

__device__ __forceinline__ int ratio(int req, int cap, bool most) {
  if (!(cap > 0 && req <= cap)) return 0;
  return floordiv(mul32(most ? req : cap - req, kMaxPriority), cap);
}

// the pass-1 reduction results every thread sees
struct Norms {
  int aff_max, intol_max;
  // SelectorSpreadPriority: node max of the feasible counts, zone max of the
  // per-zone sums, whether any feasible node has a zone
  int max_node, max_zone, have_zones;
  // InterPodAffinityPriority: max(feasible counts, 0), min(feasible counts, 0)
  int ip_max, ip_min;
};

// SelectorSpreadPriority (selector_spreading.go:66-175) of a feasible node
// with spread count c in zone z: the exact node/zone blend
__device__ __forceinline__ int spread_score(const Norms& m, int c, int z,
                                            int zsum_z) {
  const int node_num = m.max_node > 0 ? sub32(m.max_node, c) : 1;
  const int node_den = max(m.max_node, 1);
  if (m.have_zones && z != 0) {
    const int zone_num = m.max_zone > 0 ? sub32(m.max_zone, zsum_z) : 1;
    const int zone_den = max(m.max_zone, 1);
    return floordiv(
        mul32(kMaxPriority, add32(mul32(node_num, zone_den),
                                  mul32(mul32(2, zone_num), node_den))),
        mul32(mul32(3, node_den), zone_den));
  }
  return floordiv(mul32(kMaxPriority, node_num), node_den);
}

// the normalized InterPodAffinityPriority of a node with count c
__device__ __forceinline__ int interpod_score(const Norms& m, int c) {
  const int rng = sub32(m.ip_max, m.ip_min);
  if (rng <= 0) return 0;
  return floordiv(mul32(kMaxPriority, sub32(c, m.ip_min)), rng);
}

// weighted score of a feasible node
__device__ __forceinline__ int node_score(const Args& a, const PodView& p,
                                          int i, const Norms& m) {
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
  if (m.aff_max > 0) s += floordiv(mul32(kMaxPriority, p.aff[i]), m.aff_max);
  s += m.intol_max > 0
           ? kMaxPriority - floordiv(mul32(kMaxPriority, p.intol[i]), m.intol_max)
           : kMaxPriority;
  s += mul32(p.avoid[i], kAvoidWeight);
  return s;
}

// weighted score of a feasible node under a policy, before the spread and
// inter-pod terms: the eight components with the policy's weights, the
// NodeLabel priority row, ImageLocality and ServiceAntiAffinity (its
// cluster-wide feasible total and per-domain sums in `agg`)
__device__ __forceinline__ int node_score_policy(const Args& a,
                                                 const PodView& p, int i,
                                                 const Norms& m,
                                                 const PolShared& pol,
                                                 const int* agg) {
  const int n = a.npad;
  const int* w = pol.h + H_WEIGHTS;
  const int ac = a.statics[S_CPU * n + i];
  const int am = a.statics[S_MEM * n + i];
  const int tc = add32(a.carry[C_NZC * n + i], p.nzc);
  const int tm = add32(a.carry[C_NZM * n + i], p.nzm);
  int s = mul32(w[W_LEAST],
                floordiv(ratio(tc, ac, false) + ratio(tm, am, false), 2));
  s = add32(s, mul32(w[W_MOST],
                     floordiv(ratio(tc, ac, true) + ratio(tm, am, true), 2)));
  if (!(ac == 0 || tc >= ac || am == 0 || tm >= am)) {
    const int num = abs(mul32(tc, am) - mul32(tm, ac));
    const int den = mul32(ac, am);
    s = add32(s, mul32(w[W_BALANCED],
                       floordiv(mul32(kMaxPriority, den - num), den)));
  }
  if (m.aff_max > 0)
    s = add32(s, mul32(w[W_AFF],
                       floordiv(mul32(kMaxPriority, p.aff[i]), m.aff_max)));
  s = add32(s, mul32(w[W_TAINT],
                     m.intol_max > 0
                         ? kMaxPriority - floordiv(mul32(kMaxPriority,
                                                         p.intol[i]),
                                                   m.intol_max)
                         : kMaxPriority));
  s = add32(s, mul32(p.avoid[i], w[W_AVOID]));
  if (a.label_prio) s = add32(s, a.label_prio[i]);
  if (p.img) s = add32(s, mul32(p.img[i], pol.h[H_W_IMAGE]));
  // ServiceAntiAffinity (selector_spreading.go:176-280): my first service's
  // pods per label domain, normalized by their feasible total
  const int total = agg[R_SAAT];
  for (int e = 0; e < pol.h[H_N_SAA]; ++e) {
    const int d = a.saa_dom[(size_t)e * n + i];
    if (d <= 0) continue;
    const int f = total > 0
                      ? floordiv(mul32(kMaxPriority,
                                       sub32(total,
                                             agg[R_SAAS + e * kMaxZones + d])),
                                 total)
                      : kMaxPriority;
    s = add32(s, mul32(f, pol.h[H_SAA_W + e]));
  }
  return s;
}

static_assert(R_HIST == R_SAAS + kMaxSaa * kMaxZones,
              "a CTA's values hold every ServiceAntiAffinity sum");

// CTA r of a cluster of c owns the node slab [32 floor(r u / c),
// 32 floor((r + 1) u / c)) of the u = npad / 32 lane groups (kernels/
// fastscan.py slab_bounds): contiguous, in rank order, none empty while
// c <= u, none wider than 32 ceil(u / c)
__device__ __forceinline__ int slab_lo(int rank, int units, int csize) {
  return 32 * (rank * units / csize);
}

// the pass-1 value a push or gather thread moves: t < n_red the feasible
// count and maxima, then n_z zone sums, then the ServiceAntiAffinity sums
__device__ __forceinline__ int item_at(int t, int n_red, int n_z) {
  return t < n_red ? R_RED + t
         : t < n_red + n_z ? R_ZSUM + t - n_red : R_SAAT + t - n_red - n_z;
}

// One cluster of up to 16 CTAs runs the chunk, each CTA on its own SM. With
// at most 512 threads and one CTA an SM, ptxas may give a thread 128
// registers.
template <bool kGroups, bool kInterpod, bool kPolicy>
__global__ void __launch_bounds__(kMaxThreads, 1) fastscan_kernel(Args a) {
  static_assert(kGroups || !kInterpod, "inter-pod terms need pod groups");
  static_assert(kGroups || !kPolicy, "the policy variant has pod groups");
  constexpr int kRed = kInterpod ? 7 : 5;   // values the pass-1 exchange holds
  extern __shared__ int smem_scratch[];
  __shared__ int acc[kAccWords];      // my CTA's values for this pod
  __shared__ int inbox[kMaxCluster][R_HIST];  // every CTA's, pushed by rank
  __shared__ int hist_in[kMaxCluster][32];    // rank 0: every CTA's histogram
  __shared__ int agg[R_HIST];         // the cluster's pass-1 totals
  __shared__ int wpair[kMaxWarps][2];     // my warps' (score max, count)
  __shared__ int cpair[kMaxCluster][2];   // every CTA's (score max, count)
  __shared__ IpSlot<kInterpod> ip_slot;
  __shared__ PolSlot<kPolicy> pol_slot;
  __shared__ int locks[kMiscWidth];   // ServiceAffinity locks, replicated
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nwarps = nt >> 5;
  const int n = a.npad, units = n >> 5;
  const int slab = 32 * ((units + csize - 1) / csize);
  const int clo = slab_lo(rank, units, csize);
  const int chi = slab_lo(rank + 1, units, csize);
  const int per = (slab + nt - 1) / nt;
  const int lo = min(clo + tid * per, chi), hi = min(lo + per, chi);
  // per-node scratch, indexed by i - clo: read and written only by the
  // thread that owns node i
  int* scr = a.scratch_smem ? smem_scratch
                            : a.scratch + (size_t)rank * kScratchRows * slab;
  int* reason_s = scr;
  int* score_s = scr + slab;
  int* spread_s = scr + 2 * slab;
  int* ipcount_s = scr + 3 * slab;
  int* saa_s = scr + 4 * slab;
  // each CTA's replica of presence_dom (inter-pod plans), after the
  // scratch in dynamic shared memory
  int* pd_s = smem_scratch + (a.scratch_smem ? kScratchRows * slab : 0);
  const int pd_words = kInterpod ? a.gpad * a.k_keys * a.dpad : 0;
  for (int t = tid; t < pd_words; t += nt) pd_s[t] = a.pd[t];
  const bool spread = kGroups && (a.flags & F_SPREAD) != 0;
  // the bind updates presence only where a stage reads what it binds
  const bool pres_update =
      kGroups && a.gpad > 0 &&
      (kInterpod || (a.flags & (F_PORTS | F_DISK | F_SPREAD)) != 0);
  const IpShared* ips = nullptr;
  const PolShared* pols = nullptr;
  int rr = a.misc[0];
  if constexpr (kInterpod) ips = &ip_slot.s;
  for (int t = tid; t < kAccWords; t += nt) acc[t] = 0;
  if constexpr (kPolicy) {
    pols = &pol_slot.s;
    for (int t = tid; t < kPolWords; t += nt) pol_slot.s.h[t] = a.pol[t];
    for (int f = tid; f < a.pol[H_FD]; f += nt) locks[f] = a.misc[1 + f];
  }
  // every CTA of the cluster is running and initialized before any reads
  // another's shared memory
  cluster.sync();

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
    if (kGroups) {
      const int* g = pj + P_SCALAR + a.num_scalars;
      p.gid = g[0];
      p.port_w = g + 1;
      p.disk_w = g + 1 + a.words;
      p.ss_w = g + 1 + 2 * a.words;
      p.zone_ok = (a.flags & F_VOL_ZONE) ? a.zone_ok + (size_t)p.gid * n
                                         : nullptr;
      p.vols = a.n_vols ? a.vol_tbl + (size_t)p.gid * a.vol_w : nullptr;
      p.my_typed[0] = p.my_typed[1] = p.my_typed[2] = 0;
      for (int v = 0; v < a.n_vols; ++v) {
        if (p.vols[v] == 0) continue;
        for (int t = 0; t < 3; ++t) p.my_typed[t] += a.vol_type[3 * v + t];
      }
      p.maxpd = p.my_typed[0] + p.my_typed[1] + p.my_typed[2] > 0;
    }
    // whether this pod's bind locks a ServiceAffinity signature: the same
    // answer in every CTA, which all hold the same locks
    bool lock_bind = false;
    if constexpr (kPolicy) {
      // the policy columns (kernels/fastscan.py PodPolicy)
      const int* q = pj + a.pol_col;
      const int* h = pol_slot.s.h;
      p.saa_w = q;
      p.img = a.image_tbl ? a.image_tbl + (size_t)q[a.words] * n : nullptr;
      p.noexec = a.noexec_tbl ? a.noexec_tbl + (size_t)pj[P_TOL] * n
                              : nullptr;
      p.pins = q + a.words + 2;
      p.match = p.pins + h[H_LA];
      p.lock = h[H_FD] > 0 ? locks[q[a.words + 1]] : -1;
      if (h[H_SA_LOCKS]) {
        for (int f = 0; f < h[H_FD]; ++f)
          lock_bind |= locks[f] == -1 && p.match[f] != 0;
      }
    }
    if constexpr (kInterpod) {
      // every read of the last pod's phase is behind the last pod's
      // barriers; the reset must be behind one before the phase's atomics
      if (tid < kMaxTerms) ip_slot.s.tot[tid] = 0;
      if (tid == 0) ip_slot.s.fail_all = 0;
      __syncthreads();
      interpod_phase(a, pd_s, p.gid, ip_slot.s);
      __syncthreads();
    }

    // pass 1 over my nodes: reason words, feasible count, normalizer
    // maxima, for spreading the node max, the zone sums and whether a zone
    // is feasible, and for inter-pod terms the counts' max and negated min
    int red_v[kRed] = {};   // nf, aff max, intol max, node max, zoned[, ip]
    int zacc[kMaxZones];
#pragma unroll
    for (int z = 0; z < kMaxZones; ++z) zacc[z] = 0;
    int saa_acc = 0;
    bool saa = false;   // ServiceAntiAffinity entries to sum
    if constexpr (kPolicy) saa = pol_slot.s.h[H_N_SAA] > 0;
    for (int i = lo; i < hi; ++i) {
      const int l = i - clo;
      const int r = node_reason<kGroups, kInterpod, kPolicy>(a, p, i, ips,
                                                             pols);
      reason_s[l] = r;
      if (r != 0) continue;
      ++red_v[0];
      red_v[1] = max(red_v[1], p.aff[i]);
      red_v[2] = max(red_v[2], p.intol[i]);
      if (saa) {
        int c = 0;
        for (int w = 0; w < a.words; ++w) {
          unsigned bits = (unsigned)p.saa_w[w];
          while (bits) {
            const int g = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            c = add32(c, a.carry[(size_t)(a.pres_row + g) * n + i]);
          }
        }
        saa_s[l] = c;
        saa_acc = add32(saa_acc, c);
      }
      if constexpr (kInterpod) {
        const int c = interpod_count(a, *ips, i);
        ipcount_s[l] = c;
        red_v[5] = max(red_v[5], c);
        red_v[6] = max(red_v[6], -c);
      }
      if (spread) {
        const int c = spread_count(a, p, i);
        const int z = a.zone_id[i];
        spread_s[l] = c;
        red_v[3] = max(red_v[3], c);
        red_v[4] |= z != 0;
#pragma unroll
        for (int zz = 1; zz < kMaxZones; ++zz) zacc[zz] += zz == z ? c : 0;
      }
    }
    // my CTA's pass-1 values: a warp reduction, then one shared atomic a
    // value a warp
    if (spread) {
#pragma unroll
      for (int zz = 1; zz < kMaxZones; ++zz) {
        const int s = __reduce_add_sync(kFull, zacc[zz]);
        if (lane == 0 && s != 0) atomicAdd(&acc[R_ZSUM + zz], s);
      }
    }
    if constexpr (kPolicy) {
      if (saa) {
        // ServiceAntiAffinity: the feasible total, then per entry the
        // per-domain sums, in registers and one atomic a domain a warp
        const int t = __reduce_add_sync(kFull, saa_acc);
        if (lane == 0 && t != 0) atomicAdd(&acc[R_SAAT], t);
        for (int e = 0; e < pol_slot.s.h[H_N_SAA]; ++e) {
          const int* dom = a.saa_dom + (size_t)e * n;
#pragma unroll
          for (int z = 0; z < kMaxZones; ++z) zacc[z] = 0;
          for (int i = lo; i < hi; ++i) {
            if (reason_s[i - clo] != 0) continue;
            const int d = dom[i], c = saa_s[i - clo];
#pragma unroll
            for (int zz = 1; zz < kMaxZones; ++zz) zacc[zz] += zz == d ? c : 0;
          }
#pragma unroll
          for (int zz = 1; zz < kMaxZones; ++zz) {
            const int sum = __reduce_add_sync(kFull, zacc[zz]);
            if (lane == 0 && sum != 0)
              atomicAdd(&acc[R_SAAS + e * kMaxZones + zz], sum);
          }
        }
      }
    }
    red_v[0] = __reduce_add_sync(kFull, red_v[0]);
#pragma unroll
    for (int v = 1; v < kRed; ++v) red_v[v] = __reduce_max_sync(kFull, red_v[v]);
    if (lane == 0) {
      if (red_v[0] != 0) atomicAdd(&acc[R_RED], red_v[0]);
#pragma unroll
      for (int v = 1; v < kRed; ++v)
        if (red_v[v] > 0) atomicMax(&acc[R_RED + v], red_v[v]);
    }

    // push them into slot `rank` of every CTA's inbox
    const int n_z = spread ? kMaxZones : 0;
    int n_s = 0;
    if constexpr (kPolicy) n_s = saa ? 1 + kMaxZones * pol_slot.s.h[H_N_SAA] : 0;
    const int n_items = kRed + n_z + n_s;
    __syncthreads();
    for (int t = tid; t < n_items * csize; t += nt) {
      const int at = item_at(t / csize, kRed, n_z);
      cluster.map_shared_rank(&inbox[0][0], t % csize)[rank * R_HIST + at] =
          acc[at];
    }
    // cluster barrier 1: every CTA's pass-1 values are in every inbox
    cluster.sync();
    // mine have been pushed; the next pod accumulates behind the next
    // barrier
    for (int t = tid; t < R_HIST; t += nt) acc[t] = 0;
    // the cluster's totals, in rank order, from my inbox
    for (int t = tid; t < n_items; t += nt) {
      const int at = item_at(t, kRed, n_z);
      const bool is_max = at > R_RED && at < R_RED + kRed;
      int v = 0;
      for (int r = 0; r < csize; ++r)
        v = is_max ? max(v, inbox[r][at]) : add32(v, inbox[r][at]);
      agg[at] = v;
    }
    __syncthreads();
    const int nf = agg[R_RED];
    Norms m;
    m.aff_max = agg[R_RED + 1];
    m.intol_max = agg[R_RED + 2];
    m.max_node = agg[R_RED + 3];
    m.have_zones = agg[R_RED + 4];
    m.max_zone = 0;
    m.ip_max = m.ip_min = 0;
    if constexpr (kInterpod) {
      m.ip_max = agg[R_RED + 5];
      m.ip_min = -agg[R_RED + 6];
    }
    if (spread) {
      for (int zz = 1; zz < a.n_zones; ++zz)
        m.max_zone = max(m.max_zone, agg[R_ZSUM + zz]);
    }

    if (nf > 0) {
      // pass 2: scores, and each thread's max with its multiplicity
      int lmax = -1, lcnt = 0;
      for (int i = lo; i < hi; ++i) {
        const int l = i - clo;
        if (reason_s[l] != 0) continue;
        int s;
        if constexpr (kPolicy) {
          const int* w = pol_slot.s.h + H_WEIGHTS;
          s = node_score_policy(a, p, i, m, pol_slot.s, agg);
          if (spread) {
            const int z = a.zone_id[i];
            s = add32(s, mul32(w[W_SPREAD],
                               spread_score(m, spread_s[l], z,
                                            z != 0 ? agg[R_ZSUM + z] : 0)));
          }
          if constexpr (kInterpod)
            s = add32(s, mul32(w[W_INTERPOD],
                               interpod_score(m, ipcount_s[l])));
        } else {
          s = node_score(a, p, i, m);
          if (spread) {
            const int z = a.zone_id[i];
            s += spread_score(m, spread_s[l], z, z != 0 ? agg[R_ZSUM + z] : 0);
          }
          if constexpr (kInterpod)
            s += kInterpodWeight * interpod_score(m, ipcount_s[l]);
        }
        score_s[l] = s;
        if (s > lmax) {
          lmax = s;
          lcnt = 1;
        } else if (s == lmax) {
          ++lcnt;
        }
      }
      // each warp's (max, count at max), then my CTA's, pushed into slot
      // `rank` of every CTA
      const int wmax = __reduce_max_sync(kFull, lmax);
      const int wcnt = __reduce_add_sync(kFull, lmax == wmax ? lcnt : 0);
      if (lane == 0) {
        wpair[warp][0] = wmax;
        wpair[warp][1] = wcnt;
      }
      __syncthreads();
      if (warp == 0) {
        const int m = lane < nwarps ? wpair[lane][0] : INT_MIN;
        const int cmax = __reduce_max_sync(kFull, m);
        const int ccnt = __reduce_add_sync(
            kFull, lane < nwarps && m == cmax ? wpair[lane][1] : 0);
        if (lane < csize) {
          int* dst = cluster.map_shared_rank(&cpair[0][0], lane) + 2 * rank;
          dst[0] = cmax;
          dst[1] = ccnt;
        }
      }
      // cluster barrier 2: every CTA's pair is in every CTA
      cluster.sync();
      // every warp, from local copies: the score max, the ties at it, and
      // the ties before me, (rank, warp) being node order
      const int cm = lane < csize ? cpair[lane][0] : INT_MIN;
      const int gmax = __reduce_max_sync(kFull, cm);
      const int cc = lane < csize && cm == gmax ? cpair[lane][1] : 0;
      const int ties = __reduce_add_sync(kFull, cc);
      const int wm = lane < nwarps ? wpair[lane][0] : INT_MIN;
      const int wc = lane < nwarps && wm == gmax ? wpair[lane][1] : 0;
      const int wbefore = __reduce_add_sync(kFull, lane < rank ? cc : 0) +
                          __reduce_add_sync(kFull, lane < warp ? wc : 0);
      const int tcnt = (lmax == gmax) ? lcnt : 0;
      int incl = tcnt;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int before = wbefore + incl - tcnt;
      const int pick = nf > 1 ? rr % max(ties, 1) : 0;
      if (tcnt > 0 && before <= pick && pick < before + tcnt) {
        // this thread's slice holds the pick-th tie: find it and bind
        int seen = before;
        int choice = -1;
        for (int i = lo; i < hi; ++i) {
          if (reason_s[i - clo] == 0 && score_s[i - clo] == gmax) {
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
        if (kGroups) {
          if (pres_update) c[(size_t)(a.pres_row + p.gid) * n + choice] += 1;
          for (int v = 0; v < a.n_vols; ++v)
            if (p.vols[v] != 0) c[(size_t)(a.uv_row + v) * n + choice] = 1;
        }
        if constexpr (kInterpod) {
          // every CTA reads presence_dom in its next inter-pod phase: the
          // add goes into every CTA's replica
          for (int k = 0; k < a.k_keys; ++k) {
            const int idx = (p.gid * a.k_keys + k) * a.dpad +
                            a.topo[(size_t)k * n + choice];
            for (int r = 0; r < csize; ++r)
              atomicAdd(cluster.map_shared_rank(pd_s, r) + idx, 1);
          }
        }
        if constexpr (kPolicy) {
          // the first matching bind locks each unlocked signature, in every
          // CTA's copy of the locks
          if (lock_bind) {
            for (int f = 0; f < pol_slot.s.h[H_FD]; ++f) {
              if (locks[f] != -1 || p.match[f] == 0) continue;
              for (int r = 0; r < csize; ++r)
                cluster.map_shared_rank(locks, r)[f] = choice;
            }
          }
        }
        a.choices[j] = choice;
      }
      if (rank == 0 && tid < a.num_bits)
        a.counts[(size_t)j * a.num_bits + tid] = 0;
      // cluster barrier 3, only where another CTA reads what the bind
      // wrote: presence_dom, or a new ServiceAffinity lock
      if (kInterpod || lock_bind) cluster.sync();
    } else {
      // reason histogram over the real bits (pad nodes carry bit 30 only),
      // my CTA's counts in my slots
      int* hist = acc + R_HIST;
      bool count_mode = false;
      if constexpr (kPolicy) count_mode = pol_slot.s.h[H_COUNT_MODE] != 0;
      if (count_mode) {
        if constexpr (kPolicy)
          count_mode_hist<kInterpod>(a, p, lo, hi, ips, pol_slot.s, hist);
      } else {
        for (int b = 0; b < a.num_bits; ++b) {
          int cnt = 0;
          for (int i = lo; i < hi; ++i) cnt += (reason_s[i - clo] >> b) & 1;
          cnt = __reduce_add_sync(kFull, cnt);
          if (lane == 0 && cnt != 0) atomicAdd(&hist[b], cnt);
        }
      }
      // pushed into slot `rank` of rank 0's histogram inbox
      __syncthreads();
      if (tid < a.num_bits)
        cluster.map_shared_rank(&hist_in[0][0], 0)[rank * 32 + tid] = hist[tid];
      // cluster barrier 2: every CTA's histogram is in rank 0; rank 0 sums
      // them in rank order
      cluster.sync();
      if (tid < 32) hist[tid] = 0;
      if (rank == 0) {
        if (tid < a.num_bits) {
          int v = 0;
          for (int r = 0; r < csize; ++r) v = add32(v, hist_in[r][tid]);
          a.counts[(size_t)j * a.num_bits + tid] = v;
        }
        if (tid == 0) a.choices[j] = -1;
      }
    }
    if (rank == 0 && tid == 0) a.adv[j] = nf > 1 ? 1 : 0;
    rr += nf > 1 ? 1 : 0;
  }
  // no CTA exits while another can still read its shared memory
  cluster.sync();
  if (rank == 0) {
    if (tid == 0) a.misc[0] = rr;
    for (int t = tid; t < pd_words; t += nt) a.pd[t] = pd_s[t];
    if constexpr (kPolicy) {
      for (int f = tid; f < pol_slot.s.h[H_FD]; f += nt) a.misc[1 + f] = locks[f];
    }
  }
}

// the instantiation of a variant id (kernels/fastscan.py VARIANTS order)
using KernelFn = void (*)(Args);
KernelFn kernel_of(int variant) {
  switch (variant) {
    case 0: return fastscan_kernel<false, false, false>;
    case 1: return fastscan_kernel<true, false, false>;
    case 2: return fastscan_kernel<true, true, false>;
    case 3: return fastscan_kernel<true, false, true>;
    case 4: return fastscan_kernel<true, true, true>;
  }
  return nullptr;
}

// A launch configuration of one cluster of `cluster` CTAs; `attr` must
// outlive it
cudaError_t cluster_config(KernelFn kern, int cluster, int threads, int smem,
                           cudaStream_t st, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || smem < 0)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
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

// How many clusters of this geometry the card can hold at once (0: it
// cannot launch one); a negative value is a CUDA error, negated
extern "C" int tpusim_fastscan_max_clusters(int variant, int cluster,
                                            int threads, int smem) {
  const KernelFn kern = kernel_of(variant);
  if (!kern) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(kern, cluster, threads, smem, nullptr, &attr,
                                 &cfg);
  int count = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&count, kern, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return count;
}

extern "C" int tpusim_fastscan_chunk(
    const int* pods, int k, int pod_w, const int* statics, const int* sel,
    const int* tol, const int* intol, const int* aff, const int* avoid,
    const int* host, int* carry, int* misc, const int* alloc_scalar,
    int num_scalars, int* choices, int* counts, int* adv, int* scratch,
    int num_bits, int npad, int most_requested, int gpad, int pres_row,
    int flags, const int* zone_id, int n_zones, const int* zone_ok,
    const int* vol_tbl, int vol_w, const int* vol_type, int n_vols,
    int uv_row, int limit_ebs, int limit_gce, int limit_azure, int k_keys,
    int d_doms, int ta, int tb, int tp, int hard_weight, const int* topo,
    const int* ipod, int wip, const int* exist, int* pd, int dpad,
    const int* pol,
    const int* label_tbl, const int* label_prio, const int* image_tbl,
    const int* noexec_tbl, const int* saa_dom, const int* sa_val,
    int cluster, int threads, int smem, int scratch_smem, void* stream) {
  if (k <= 0) return 0;
  if (num_bits > 32 || npad <= 0 || npad % 32 != 0) return (int)cudaErrorInvalidValue;
  if (cluster > npad / 32) return (int)cudaErrorInvalidValue;
  const int slab = 32 * ((npad / 32 + cluster - 1) / cluster);
  const int scratch_bytes = scratch_smem ? kScratchRows * slab * 4 : 0;
  const int pd_bytes = k_keys > 0 ? gpad * k_keys * dpad * 4 : 0;
  if ((!scratch_smem && !scratch) || smem < scratch_bytes + pd_bytes)
    return (int)cudaErrorInvalidValue;
  if ((flags & F_SPREAD) && (n_zones <= 0 || n_zones > kMaxZones || !zone_id))
    return (int)cudaErrorInvalidValue;
  if ((flags & (F_PORTS | F_DISK | F_SPREAD)) && gpad <= 0)
    return (int)cudaErrorInvalidValue;
  if ((flags & F_VOL_ZONE) && !zone_ok) return (int)cudaErrorInvalidValue;
  if (n_vols < 0 || (n_vols > 0 && (!vol_tbl || !vol_type || vol_w < n_vols)))
    return (int)cudaErrorInvalidValue;
  const bool interpod = k_keys > 0;
  IpLayout lay = {};
  if (interpod) {
    if (k_keys > kMaxKeys || d_doms < 1 || d_doms > kMaxDoms || ta < 1 ||
        ta > kMaxTerms || tb < 1 || tb > kMaxTerms || tp < 1 ||
        tp > kMaxTerms || gpad < 1 || gpad > 32 * kMaxIpWords || !topo ||
        !ipod || !exist || !pd || dpad < d_doms)
      return (int)cudaErrorInvalidValue;
    lay = ip_layout(ta, tb, tp, gpad);
    if (wip < lay.width) return (int)cudaErrorInvalidValue;
  }
  const bool policy = pol != nullptr;
  if (policy && saa_dom && gpad <= 0) return (int)cudaErrorInvalidValue;
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
  a.scratch_smem = scratch_smem != 0;
  a.k = k;
  a.pod_w = pod_w;
  a.num_scalars = num_scalars;
  a.num_bits = num_bits;
  a.npad = npad;
  a.most_requested = most_requested;
  a.gpad = gpad;
  a.words = (gpad + 31) / 32;
  a.pres_row = pres_row;
  a.flags = flags;
  a.zone_id = zone_id;
  a.n_zones = n_zones;
  a.zone_ok = zone_ok;
  a.vol_tbl = vol_tbl;
  a.vol_w = vol_w;
  a.vol_type = vol_type;
  a.n_vols = n_vols;
  a.uv_row = uv_row;
  a.limit[0] = limit_ebs;
  a.limit[1] = limit_gce;
  a.limit[2] = limit_azure;
  a.k_keys = k_keys;
  a.d_doms = d_doms;
  a.ta = ta;
  a.tb = tb;
  a.tp = tp;
  a.hard_weight = hard_weight;
  a.topo = topo;
  a.ipod = ipod;
  a.wip = wip;
  a.exist = exist;
  a.pd = pd;
  a.dpad = dpad;
  a.lay = lay;
  a.pol = pol;
  a.label_tbl = label_tbl;
  a.label_prio = label_prio;
  a.image_tbl = image_tbl;
  a.noexec_tbl = noexec_tbl;
  a.saa_dom = saa_dom;
  a.sa_val = sa_val;
  a.pol_col = P_SCALAR + num_scalars + 1 + 3 * a.words;
  const bool groups = gpad > 0 || flags != 0 || n_vols > 0;
  const int variant = policy ? (interpod ? 4 : 3)
                      : interpod ? 2 : groups ? 1 : 0;
  const KernelFn kern = kernel_of(variant);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(kern, cluster, threads, smem,
                                 (cudaStream_t)stream, &attr, &cfg);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}
