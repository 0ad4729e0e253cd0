// Merge of a sorted top-C candidate buffer with a pass's new entries, in
// place: the probing loop's and the beam loop's batch_merge_topc.
//
//   for each row b: (ids_a, d2_a, vis_a)[b, :C] <- the first C entries of
//   the stable sort by d2 of [buffer row b (C entries) ; new row b (K)]
//
// The buffer must already be ascending in that sort's order (it is the
// previous merge's output); the K new entries come in any order.  Keys are
// ordered as PyTorch's stable CUDA sort orders a row (a cub radix sort, at
// every row width): on the float's bits made unsigned, with -0.0 equal to
// +0.0, a negative NaN before -inf and a positive NaN after +inf.  Ties go
// by position: the buffer first, then the new entries by column.
//
// Replaces no TPU kernel: the JAX package merges with lax.top_k over the
// concatenation (src/repro/core/search.py:125), which the port did with a
// stable sort of [B, C + K], a cat and two gathers, twice a pass.  The
// buffer it sorted was already sorted, and most rows insert nothing.
//
// Bound on the card: bytes.  A row whose smallest new key is not below the
// buffer's last key is unchanged (a tie goes to the buffer): it reads its K
// keys and that one key, and writes nothing.  Every finished row is one,
// since its new entries are all +inf.  In an active row one warp sorts the
// K new (key, column) pairs by rank in shared memory, finds by binary
// search how many buffer keys lie at or below each (ub), and moves only
// the buffer's suffix from the first changed position p0 = ub of the
// smallest: buffer entry i goes to i + #{new keys below it}, the new entry
// of rank r to ub[r] + r, ranks that land at C or past dropped.  The move
// is in place: every buffer entry moves right and the final positions are
// distinct, so the suffix goes right to left in chunks held in registers,
// each chunk read in full before any of it is written, and the new entries
// land last.  Rows go on grid.x, four a block (one warp each) while their
// 12 K bytes of shared memory fit four to 48 KB, else one.

#include <cstdint>

namespace {

constexpr int kManyRowsK = 1024;   // up to this K, four rows a block
constexpr int kChunk = 4;          // buffer entries a lane carries a chunk
constexpr unsigned kAll = 0xffffffffu;

// The card's sort order as an unsigned key: cub's radix sort key.
__device__ __forceinline__ uint32_t sort_key(float x) {
  uint32_t b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;                   // -0.0 sorts as +0.0
  return b ^ ((b & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

__global__ void merge_topc_kernel(int32_t* ids_a, float* d2_a, uint8_t* vis_a,
                                  const int32_t* __restrict__ ids_b,
                                  const float* __restrict__ d2_b,
                                  const uint8_t* __restrict__ vis_b,
                                  int B, int C, int K) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;
  uint32_t* keys = smem + (size_t)warp * 3 * K;   // new keys, by column
  int* order = reinterpret_cast<int*>(keys + K);  // column of rank r
  int* ub = order + K;                            // buffer keys <= rank r's
  int32_t* ia = ids_a + row * C;
  float* da = d2_a + row * C;
  uint8_t* va = vis_a + row * C;
  const int32_t* ib = ids_b + row * K;
  const float* db = d2_b + row * K;
  const uint8_t* vb = vis_b + row * K;

  const uint32_t last = sort_key(da[C - 1]);
  uint32_t least = 0xffffffffu;
  for (int j = lane; j < K; j += 32) {
    const uint32_t k = sort_key(db[j]);
    keys[j] = k;
    least = min(least, k);
  }
  for (int o = 16; o > 0; o >>= 1)
    least = min(least, __shfl_xor_sync(kAll, least, o));
  if (least >= last) return;                      // nothing enters the row
  __syncwarp();

  // stable rank of each new entry among the new ones
  for (int j = lane; j < K; j += 32) {
    const uint32_t k = keys[j];
    int r = 0;
    for (int t = 0; t < K; ++t) {
      const uint32_t kt = keys[t];
      r += (kt < k) | ((kt == k) & (t < j));
    }
    order[r] = j;
  }
  __syncwarp();

  // ub[r]: buffer entries at or below rank r's key (nondecreasing in r)
  int landed = 0;                                 // new entries kept
  for (int r = lane; r < K; r += 32) {
    const uint32_t k = keys[order[r]];
    int lo = 0, hi = C - 1;                       // the buffer's last is > k
    if (k >= last) lo = C;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sort_key(da[mid]) > k) hi = mid; else lo = mid + 1;
    }
    ub[r] = lo;
    landed += lo + r < C;
  }
  for (int o = 16; o > 0; o >>= 1) landed += __shfl_xor_sync(kAll, landed, o);
  __syncwarp();

  // buffer entries p0 .. end - 1 stay, each moved right past the new
  // entries below it; right to left, a chunk read before it is written
  const int p0 = ub[0];
  const int end = C - landed;
  for (int top = end; top > p0; top -= 32 * kChunk) {
    const int bottom = max(p0, top - 32 * kChunk);
    int32_t id[kChunk];
    float d2[kChunk];
    uint8_t vis[kChunk];
    int dst[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int i = bottom + t * 32 + lane;
      dst[t] = -1;
      if (i < top) {
        id[t] = ia[i];
        d2[t] = da[i];
        vis[t] = va[i];
        int lo = 0, hi = K;                       // ranks with ub <= i
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ub[mid] <= i) lo = mid + 1; else hi = mid;
        }
        dst[t] = i + lo;
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (dst[t] >= 0) {
        ia[dst[t]] = id[t];
        da[dst[t]] = d2[t];
        va[dst[t]] = vis[t];
      }
    }
    __syncwarp();
  }

  // the new entries into the places the buffer left
  for (int r = lane; r < K; r += 32) {
    const int dst = ub[r] + r;
    if (dst < C) {
      const int j = order[r];
      ia[dst] = ib[j];
      da[dst] = db[j];
      va[dst] = vb[j];
    }
  }
}

}  // namespace

// ids_a int32 [B, C], d2_a f32 [B, C], vis_a bool [B, C]: the buffer,
// updated in place; ids_b, d2_b, vis_b [B, K]: the new entries.  Returns
// cudaGetLastError() after the launch (nothing is launched for B or K 0).
extern "C" int merge_topc(int32_t* ids_a, float* d2_a, uint8_t* vis_a,
                          const int32_t* ids_b, const float* d2_b,
                          const uint8_t* vis_b, int B, int C, int K,
                          void* stream) {
  if (B == 0 || K == 0) return 0;
  const int rows = K <= kManyRowsK ? 4 : 1;
  const size_t smem = (size_t)rows * 3 * K * sizeof(uint32_t);
  merge_topc_kernel<<<(B + rows - 1) / rows, rows * 32, smem,
                      (cudaStream_t)stream>>>(
      ids_a, d2_a, vis_a, ids_b, d2_b, vis_b, B, C, K);
  return (int)cudaGetLastError();
}
