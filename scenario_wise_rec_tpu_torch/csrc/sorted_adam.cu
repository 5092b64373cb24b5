// Exact dense torch-Adam over a whole [V, D] embedding table, after summing
// the batch's duplicate-id gradient rows. In place on table, mu and nu.
//
// Replaces the TPU kernel
//   scenario_wise_rec_tpu/ops/pallas/sorted_adam.py:281 sorted_dense_adam_apply
// (its Pallas body `_kernel`, :86-156). Same function: ids sorted ascending,
// one gradient row per id occurrence; every table row, touched or not, gets
//   g  = sum of its rows' gradients + wd * p
//   mu = b1 * mu + (1 - b1) * g
//   nu = b2 * nu + (1 - b2) * g * g
//   p  = p - lr * (mu * bc1r) / (sqrt(nu * bc2r) + eps)
// with bc1r = 1 / (1 - b1^t), bc2r = 1 / (1 - b2^t). Ids outside [0, V),
// negative ones included, contribute nothing.
//
// The row-sharded form replaces
//   scenario_wise_rec_tpu/ops/pallas/sorted_adam.py:436 sorted_dense_adam_apply_sharded
// (a shard_map of the same pallas_call over a table row-sharded on a mesh's
// embed axis). Every entry takes `row0`: table, mu and nu hold the rows
// [row0, row0 + v) of the table the sorted ids address (row0 = 0 and v = V:
// the whole table). No ids are re-based and no [K] temporary is made; ids
// before or past the shard reach none of its tiles. The shard's tiles are the
// whole table's tiles that meet it (embedding_adam.cuh, `first_tile`), so each
// of its rows is summed and stepped exactly as the unsharded call steps it:
// the shards of a table together equal one unsharded call bit for bit. Its
// bound is the shard's bytes, 1/E of the table's, plus the ids and gradient
// rows that reach its tiles.
//
// Two storage forms, as the TPU kernel takes f32 or bf16 tiles: table, mu and
// nu all f32 (`sorted_dense_adam_f32`) or all bf16 (`sorted_dense_adam_bf16`;
// the ids int32 and the gradient rows f32 in both). The bf16 form does the
// Adam math in f32 and rounds each stored result to nearest even. Each form
// takes the 7 Adam numbers by value, or (`..._dev`) from a [7] f32 array in
// device memory, the form a CUDA graph of the train step replays.
//
// Bound: bytes. Every row of table, mu and nu is read and written once
// (6 * V * D * 4 bytes; 4.12 GB at the Ali-CCP shape, V = 10,741,000, D = 16)
// plus the K ids and K gradient rows, against ~14 flops per element. At
// 3.35 TB/s that is ~1.23 ms; nothing here may cost more than the stream.
// The bf16 form moves half: 6 * V * D * 2 bytes = 2.0623 GB, plus 6.4 MB of
// ids and gradient rows (K = 94,208), 2.0687 GB in all, ~0.6175 ms.
//
// Design (not the TPU's: its lane-dispersed [K, 128] gradient matrix, one-hot
// MXU segment sum and sequential work list exist for a core that runs its grid
// in order):
//   1. `tile_starts_kernel`: for every tile of `block_rows` vocab rows, the
//      first sorted position whose id reaches the tile (a binary search per
//      tile boundary, all in parallel). Tile t owns positions
//      [starts[t], starts[t+1]); ids below 0 sort before tile 0 and ids >= V
//      after the last tile, so they reach no tile.
//   2. `dense_adam_kernel`, one block per tile. Ids are sorted, so a tile's
//      ids are one contiguous span and no row is shared with another block:
//      no cross-block reduction, no atomics. The block stages its span in
//      shared memory, `stage_rows` positions at a time, with coalesced loads;
//      then warp w sums columns w, w + 8, ...: its 32 lanes take 32
//      consecutive positions and a segmented warp scan (shuffles, head flags
//      from the id changes) leaves each run's total in the run's last lane,
//      which adds it to the tile's shared accumulator [block_rows, D]. A hot
//      row of thousands of duplicates is summed 32 positions per step by
//      every warp at once, not by one thread. The order of the sum is fixed
//      by the data, so the result is the same on every run.
//   3. The same block streams Adam over its whole tile (rows with no id
//      decay too) with 16-byte loads and stores where D % 4 == 0 (f32) or
//      D % 8 == 0 (bf16) and the three arrays are 16-byte aligned.
// The device code (steps 1-3, and the rounding rule of the Adam chain) is
// shared with csrc/fused_adam.cu in csrc/embedding_adam.cuh.
//
// Plain C interface (no PyTorch headers), built with nvcc for sm_90a and
// loaded with ctypes (ops/kernels/_build.py). The kernels run on the caller's
// stream and allocate nothing: `starts` ([ceil(V / block_rows) + 1] int32) is
// the caller's scratch.

#include "embedding_adam.cuh"

extern "C" {

// Dynamic shared memory one block of the Adam kernel needs, in either form
// (the accumulator is f32 whatever the storage type).
size_t sorted_dense_adam_smem_bytes(int d, int block_rows) {
  return emb_adam::smem_bytes(d, block_rows, 1);
}

// table, mu, nu: [v, d] f32, the rows [row0, row0 + v) of the table the ids
// address, updated in place. ids: [k] int32 sorted ascending; g: [k, d] f32
// aligned with ids. starts: [nb + 1] int32 scratch, nb = ceil((row0 + v) /
// block_rows) - floor(row0 / block_rows), the table's tiles that meet the
// rows. Returns cudaGetLastError() after the launches (0 = success).
int sorted_dense_adam_f32(float* table, float* mu, float* nu, const int* ids,
                          const float* g, int* starts, long long v, long long row0,
                          int d, int k, int block_rows, float lr, float wd, float b1,
                          float b2, float bc1r, float bc2r, float eps, void* stream) {
  const emb_adam::Hp h{lr, wd, b1, b2, bc1r, bc2r, eps};
  return emb_adam::launch(table, mu, nu, ids, nullptr, g, nullptr, 1, starts, v,
                          d, k, block_rows, h, stream, nullptr, row0);
}

// The same with table, mu and nu bf16 [v, d]; ids and g as above.
int sorted_dense_adam_bf16(__nv_bfloat16* table, __nv_bfloat16* mu, __nv_bfloat16* nu,
                           const int* ids, const float* g, int* starts, long long v,
                           long long row0, int d, int k, int block_rows, float lr,
                           float wd, float b1, float b2, float bc1r, float bc2r,
                           float eps, void* stream) {
  const emb_adam::Hp h{lr, wd, b1, b2, bc1r, bc2r, eps};
  return emb_adam::launch(table, mu, nu, ids, nullptr, g, nullptr, 1, starts, v,
                          d, k, block_rows, h, stream, nullptr, row0);
}

// The two forms again, the Adam numbers read from hp: [7] f32 in device
// memory, (lr, wd, b1, b2, bc1r, bc2r, eps), each block loading them once. A
// CUDA graph that captures this launch reads whatever hp holds at each
// replay, so a captured step can take step t's bias corrections.
int sorted_dense_adam_f32_dev(float* table, float* mu, float* nu, const int* ids,
                              const float* g, int* starts, long long v, long long row0,
                              int d, int k, int block_rows, const float* hp,
                              void* stream) {
  const emb_adam::Hp h{};
  return emb_adam::launch(table, mu, nu, ids, nullptr, g, nullptr, 1, starts, v,
                          d, k, block_rows, h, stream, hp, row0);
}

int sorted_dense_adam_bf16_dev(__nv_bfloat16* table, __nv_bfloat16* mu,
                               __nv_bfloat16* nu, const int* ids, const float* g,
                               int* starts, long long v, long long row0, int d, int k,
                               int block_rows, const float* hp, void* stream) {
  const emb_adam::Hp h{};
  return emb_adam::launch(table, mu, nu, ids, nullptr, g, nullptr, 1, starts, v,
                          d, k, block_rows, h, stream, hp, row0);
}

}  // extern "C"
