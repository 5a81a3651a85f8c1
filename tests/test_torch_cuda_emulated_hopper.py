"""The Hopper instruction wrappers of ``csrc/hopper.cuh`` under the CPU
emulation of ``tests/_cuda_emu.py`` (their stand-ins in
``tests/cuda_emu/cuda_runtime.h``), through small probe kernels compiled
here the way the kernels' sources are:

* ``wgmma`` m64nNk16 (N 32 to 256) over a 64-deep reduction, four 16-deep
  steps, both operands loaded by TMA in the 128-byte swizzle and read
  through descriptors, K-major and MN-major (the transpose bits) for A and
  B, and A from registers in the PTX fragment layout: the accumulator
  fragments against a plain fp32 product of the same bf16 values;
* TMA boxes that run past the tensor's edges (and start before them): the
  box in shared memory, read back through the swizzle, equals the tensor's
  values there and zeros outside;
* an mbarrier ring of two stages over five rounds (the parity wraps
  twice): every round's box arrives, and a read before the wait sees the
  stage's previous contents, as it may on the card;
* the tensor-map encoder refuses a row stride that is not a multiple of
  16 bytes, as the driver does.
"""
import ctypes

import numpy as np
import pytest
import torch
from _cuda_emu import _compile

PROBES = r'''
#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

int map2(CUtensorMap* m, const void* base, int cols, int rows, int box0,
         int box1) {
  const uint64_t dims[3] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows), 1};
  const uint64_t strides[2] = {static_cast<uint64_t>(cols) * 2,
                               static_cast<uint64_t>(rows) * cols * 2};
  const uint32_t box[3] = {static_cast<uint32_t>(box0),
                           static_cast<uint32_t>(box1), 1};
  return repro::tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 3, dims,
                           strides, box);
}

// D (64 x N) = A (64 x 64) . B (64 x N).  A in memory: TA 0 rows m of 64 k
// (K-major), TA 1 rows k of 64 m; B: TB 0 rows n of 64 k (K-major), TB 1
// rows k of N n.  RS: A from registers (read from A's K-major rows).
template <int N, int TA, int TB, int RS>
__global__ void wgmma_probe(const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tb,
                            const bf16* a, float* d) {
  constexpr int NB = TB == 1 && N < 64 ? 64 : N;   // B's box columns
  extern __shared__ float smem[];
  char* as = repro::align1024(smem);
  char* bs = as + 64 * 64 * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + 64 * NB * 2);
  const int t = threadIdx.x, warp = t / 32, g = (t % 32) / 4, q = t % 4;
  if (t == 0) {
    repro::mbar_init(bar, 1);
    repro::mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    repro::mbar_arrive_expect_tx(bar, 64 * 64 * 2 + 64 * NB * 2);
    repro::tma_load_3d(as, &ta, bar, 0, 0, 0);
    if (TB == 0) {
      repro::tma_load_3d(bs, &tb, bar, 0, 0, 0);
    } else {
      for (int j = 0; j < N / 64 || j == 0; ++j)
        repro::tma_load_3d(bs + j * 64 * 128, &tb, bar, 64 * j, 0, 0);
    }
  }
  repro::mbar_wait(bar, 0);
  float acc[N / 2];
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  repro::wgmma_fence();
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db =
        TB == 0 ? repro::desc128(bs + 32 * kk, 16, 1024)
                : repro::desc128(bs + 2048 * kk, 64 * 128, 1024);
    if (RS) {
      uint32_t af[4];
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * warp + g + 8 * (i % 2);
        const int k = 16 * kk + 2 * q + 8 * (i / 2);
        af[i] = repro::pack_bf16x2(__bfloat162float(a[r * 64 + k]),
                                   __bfloat162float(a[r * 64 + k + 1]));
      }
      repro::wgmma_rs<N, TB>(acc, af, db);
    } else {
      const uint64_t da = TA == 0 ? repro::desc128(as + 32 * kk, 16, 1024)
                                  : repro::desc128(as + 2048 * kk, 8192,
                                                   1024);
      repro::wgmma_ss<N, TA, TB>(acc, da, db);
    }
  }
  repro::wgmma_commit();
  repro::wgmma_wait<0>();
  repro::fence_regs(acc);
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e)
      d[(16 * warp + g + 8 * (e / 2)) * N + 8 * j + 2 * q + e % 2] =
          acc[4 * j + e];
}

template <int N, int TA, int TB, int RS>
int run_wgmma(const bf16* a, const bf16* b, float* d) {
  CUtensorMap ta, tb;
  int err = map2(&ta, a, 64, 64, 64, 64);
  if (!err)
    err = TB == 0 ? map2(&tb, b, 64, N, 64, N) : map2(&tb, b, N, 64, 64, 64);
  if (err) return err;
  auto kern = wgmma_probe<N, TA, TB, RS>;
  kern<<<1, 128, 4096 + 64 * 64 * 2 + 64 * 256 * 2, nullptr>>>(ta, tb, a,
                                                                d);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int run_n(const bf16* a, const bf16* b, float* d, int ta, int tb, int rs) {
  if (rs) return tb ? run_wgmma<N, 0, 1, 1>(a, b, d)
                    : run_wgmma<N, 0, 0, 1>(a, b, d);
  if (ta) return tb ? run_wgmma<N, 1, 1, 0>(a, b, d)
                    : run_wgmma<N, 1, 0, 0>(a, b, d);
  return tb ? run_wgmma<N, 0, 1, 0>(a, b, d) : run_wgmma<N, 0, 0, 0>(a, b, d);
}

// one box of 64 columns x `box_rows` rows at (c0, c1) of a rows x cols
// matrix, read back from shared memory through the swizzle
__global__ void box_probe(const __grid_constant__ CUtensorMap tm, int c0,
                          int c1, int box_rows, bf16* out) {
  extern __shared__ float smem[];
  char* tile = repro::align1024(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile + box_rows * 128);
  if (threadIdx.x == 0) {
    repro::mbar_init(bar, 1);
    repro::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    repro::mbar_arrive_expect_tx(bar, box_rows * 128);
    repro::tma_load_3d(tile, &tm, bar, c0, c1, 0);
  }
  repro::mbar_wait(bar, 0);
  for (int e = threadIdx.x; e < box_rows * 64; e += blockDim.x)
    out[e] = *reinterpret_cast<const bf16*>(
        tile + repro::swz128(static_cast<uint32_t>(e * 2)));
}

// a producer thread (warp 4) and 128 consumers over a ring of two stages:
// round i's box (64 x 64 at row 64 i) into stage i % 2; `stale[i]` the
// stage's first value as a consumer read it before its wait
__global__ void ring_probe(const __grid_constant__ CUtensorMap tm,
                           int rounds, bf16* out, float* stale) {
  extern __shared__ float smem[];
  char* ring = repro::align1024(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * 8192);
  uint64_t* empty = full + 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 128);
      *reinterpret_cast<bf16*>(ring + s * 8192) = __float2bfloat16(-1.0f);
    }
    repro::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      int stage = 0, phase = 0;
      for (int i = 0; i < rounds; ++i) {
        repro::mbar_wait(&empty[stage], phase ^ 1);
        repro::mbar_arrive_expect_tx(&full[stage], 8192);
        repro::tma_load_3d(ring + stage * 8192, &tm, &full[stage], 0, 64 * i,
                           0);
        if (++stage == 2) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    int stage = 0, phase = 0;
    for (int i = 0; i < rounds; ++i) {
      const char* st = ring + stage * 8192;
      // no consumer waits (and so, under the emulation, carries the copy
      // out) before the first one has read the stage
      repro::named_barrier(1, 128);
      if (threadIdx.x == 0)
        stale[i] = __bfloat162float(*reinterpret_cast<const bf16*>(st));
      repro::named_barrier(1, 128);
      repro::mbar_wait(&full[stage], phase);
      for (int e = threadIdx.x; e < 64 * 64; e += 128)
        out[i * 64 * 64 + e] = *reinterpret_cast<const bf16*>(
            st + repro::swz128(static_cast<uint32_t>(e * 2)));
      repro::mbar_arrive(&empty[stage]);
      if (++stage == 2) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

}  // namespace

extern "C" int wgmma_probe_run(const void* a, const void* b, float* d, int n,
                               int ta, int tb, int rs) {
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  switch (n) {
    case 32: return run_n<32>(A, B, d, ta, tb, rs);
    case 64: return run_n<64>(A, B, d, ta, tb, rs);
    case 128: return run_n<128>(A, B, d, ta, tb, rs);
    case 256: return run_n<256>(A, B, d, ta, tb, rs);
  }
  return 1;
}

extern "C" int box_probe_run(const void* src, int rows, int cols, int c0,
                             int c1, int box_rows, void* out) {
  CUtensorMap tm;
  const int err = map2(&tm, src, cols, rows, 64, box_rows);
  if (err) return err;
  box_probe<<<1, 128, 2048 + box_rows * 128, nullptr>>>(
      tm, c0, c1, box_rows, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ring_probe_run(const void* src, int rounds, void* out,
                              float* stale) {
  CUtensorMap tm;
  const int err = map2(&tm, src, 64, 64 * rounds, 64, 64);
  if (err) return err;
  ring_probe<<<1, 160, 2048 + 2 * 8192, nullptr>>>(
      tm, rounds, static_cast<bf16*>(out), stale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int map_probe(const void* base, int cols) {
  CUtensorMap tm;
  return map2(&tm, base, cols, 8, 64, 8);   // rows of 2 cols bytes
}
'''

_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    lib = _compile(PROBES, tmp_path_factory.mktemp("hopper"), "hopper")
    lib.wgmma_probe_run.argtypes = [_P, _P, _P] + [_I] * 4
    lib.box_probe_run.argtypes = [_P] + [_I] * 5 + [_P]
    lib.ring_probe_run.argtypes = [_P, _I, _P, _P]
    lib.map_probe.argtypes = [_P, _I]
    for fn in (lib.wgmma_probe_run, lib.box_probe_run, lib.ring_probe_run,
               lib.map_probe):
        fn.restype = _I
    return lib


def _bf16(rng, shape):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32) \
        .to(torch.bfloat16)


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("n,ta,tb,rs", [
    (64, 0, 0, 0), (64, 1, 0, 0), (64, 0, 1, 0), (64, 1, 1, 0),
    (32, 0, 0, 0), (128, 0, 1, 0), (256, 1, 1, 0), (256, 0, 0, 0),
    (64, 0, 0, 1), (128, 0, 1, 1), (32, 0, 1, 1), (256, 0, 1, 1),
])
def test_wgmma_against_a_plain_product(probes, n, ta, tb, rs):
    rng = np.random.default_rng(100 * n + 10 * ta + 2 * tb + rs)
    A = _bf16(rng, (64, 64))           # A[m, k]
    B = _bf16(rng, (64, n))            # B[k, n]
    a_mem = A.t().contiguous() if ta else A          # MN-major: rows of k
    b_mem = B.contiguous() if tb else B.t().contiguous()   # K-major: rows n
    d = torch.full((64, n), float("nan"))
    assert probes.wgmma_probe_run(_p(a_mem), _p(b_mem), _p(d), n, ta, tb,
                                  rs) == 0
    want = A.float() @ B.float()
    torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rows,cols,c0,c1,box_rows", [
    (70, 104, 64, 40, 64),     # the last 40 columns and rows 40..69 inside
    (50, 64, 0, 0, 64),        # rows past the end
    (30, 80, -8, -3, 16),      # starting before the tensor
    (300, 136, 72, 256, 128),  # a 128-row box, both edges ragged
])
def test_tma_box_zero_fills_outside(probes, rows, cols, c0, c1, box_rows):
    rng = np.random.default_rng(rows + cols)
    src = _bf16(rng, (rows, cols))
    out = torch.full((box_rows, 64), float("nan"), dtype=torch.bfloat16)
    assert probes.box_probe_run(_p(src), rows, cols, c0, c1, box_rows,
                                _p(out)) == 0
    want = torch.zeros((box_rows, 64), dtype=torch.bfloat16)
    for r in range(box_rows):
        for c in range(64):
            y, x = c1 + r, c0 + c
            if 0 <= y < rows and 0 <= x < cols:
                want[r, c] = src[y, x]
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


def test_mbarrier_ring_wraps_its_parity(probes):
    rounds = 5
    rng = np.random.default_rng(3)
    src = _bf16(rng, (64 * rounds, 64))
    out = torch.zeros((rounds, 64, 64), dtype=torch.bfloat16)
    stale = torch.zeros(rounds)
    assert probes.ring_probe_run(_p(src), rounds, _p(out), _p(stale)) == 0
    assert torch.equal(out.reshape(-1, 64).view(torch.int16),
                       src.view(torch.int16))
    # before its wait a stage still holds the box of two rounds back (the
    # sentinel -1 before the first)
    want = [-1.0, -1.0] + [float(src[64 * (i - 2), 0])
                           for i in range(2, rounds)]
    assert stale.tolist() == want


def test_tensor_map_refuses_unaligned_strides(probes):
    base = torch.zeros((8, 64), dtype=torch.bfloat16)
    assert probes.map_probe(_p(base), 64) == 0
    assert probes.map_probe(_p(base), 60) != 0      # 120-byte rows
    assert probes.map_probe(ctypes.c_void_p(base.data_ptr() + 2), 64) != 0
