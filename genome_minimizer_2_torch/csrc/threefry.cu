// threefry for Hopper (sm_90a): the port's counter-based random numbers
// (core/prng.py) as one launch a call. Under one key, or a key each, the
// Threefry-2x32 block function (20 rounds) of a run of 64-bit counts or of a
// table of count words; written out as both words (a key's split and
// fold_in), their xor (random bits), or that word through the uniform or
// the normal transform.
//
// Replaces no TPU kernel: the JAX package leaves jax.random to XLA, which
// fuses a draw into its loops. The port's plain version, core/prng.py's
// torch code, is elementwise int64 and float64 torch: a key split is 176
// dispatched ops and a normal draw 446, each a launch on 2 to 2,048 values,
// so that every training and validation step replayed some 600 tiny kernels
// for its key split and noise.
//
// What bounds it on an H100: launch latency. A step's split is 2 words and
// its noise 2,048 values (8 KB written); the sampler's draw is 16,384 x 64
// values (4 MB, 1.3 us at 3.35 TB/s); the largest call, init_from_key's
// uniforms, writes 4 B a value. A value costs about 150 integer and 40
// float64 operations, far below the card's rates at these sizes. So the
// design is one launch a call, grid-strided, one thread a count: the key
// words are read from device memory (a captured CUDA graph replays the
// launch on whatever key the state then holds), the output comes from the
// caching allocator, nothing is read back to the host.
//
// Bits: equal to core/prng.py's torch code on the CPU, whose draws equal
// JAX's (tests/test_torch_port_prng.py):
// - the threefry in uint32 registers, whose wrap is the torch code's
//   & 0xFFFFFFFF;
// - each of the torch code's _fma(a, b, c) as a float64 product and sum,
//   __dmul_rn and __dadd_rn, then one rounding to float32 (with no
//   contraction into a float64 FMA, which would round the product of a
//   float32 and a float64 constant once fewer);
// - every float32 + - * / through __fadd_rn, __fsub_rn, __fmul_rn and
//   __fdiv_rn, which nvcc never contracts into an FMA (log1p's
//   y - y2 * 0.5 would otherwise change bits);
// - erfinv's tail root as the float64 __dsqrt_rn rounded to float32;
// - float32 constants as their float64 value rounded to float32 (what
//   torch.full does with the Python float), float64 constants as the
//   Python floats (every one of them is a float32 value).
// No build flag is needed for any of this (ops/_build.py's flags are
// shared by every kernel).

#include <cuda_runtime.h>

#include <cstdint>

namespace gm2::threefry {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;  // the grid strides beyond

enum Kind : int { PAIRS = 0, BITS = 1, UNIFORM = 2, NORMAL = 3 };

struct Launch {
  const long long* key;     // (n_keys, 2) words; null with `words`
  long long n_keys;
  long long per_key;        // counts under each key
  long long first;          // the first count, where `counts` is null
  const long long* counts;  // or each count's low word (its high word 0)
  long long counts_stride;  // 0 (one count for every key) or 1
  const long long* words;   // given words in place of the threefry's
  float lo, hi;             // the uniform's bounds
  void* out;
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x1, uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  constexpr int R[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x1 + ks[0], b = x2 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl(b, R[i % 2][j]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  x1 = a;
  x2 = b;
}

// core/prng.py::_fma: float64 a * b + c rounded once to float32
__device__ __forceinline__ float fma64(float a, double b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), b), c));
}

#define F32(x) static_cast<float>(x)

// core/prng.py::log1p, XLA's float32 log1p as its CPU backend compiles it
__device__ float log1p_xla(float x) {
  // -- log(1 + x) --
  const float a = __fadd_rn(x, 1.0f);
  const float m = a > F32(1.1754943508222875e-38) ? a : F32(1.1754943508222875e-38);
  const int bits = __float_as_int(m);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 127), 1.0f);
  const float f = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool lt = f < F32(0.7071067690849304);
  const float y = __fadd_rn(__fadd_rn(f, -1.0f), lt ? f : 0.0f);
  if (lt) e = __fsub_rn(e, 1.0f);
  const float y2 = __fmul_rn(y, y);
  const float y3 = __fmul_rn(y, y2);
  const float p1 = fma64(fma64(y, 0.07037683576345444, -0.11514610052108765), y,
                         0.11676998436450958);
  const float p2 = fma64(fma64(y, -0.12420140951871872, 0.14249323308467865), y,
                         -0.16668057441711426);
  const float p3 = fma64(fma64(y, 0.2000071406364441, -0.24999994039535522), y,
                         0.3333333134651184);
  const float q = fma64(fma64(fma64(p1, y3, p2), y3, p3), y3,
                        __fmul_rn(e, F32(-0.00021219444170128554)));
  float large = fma64(e, 0.693359375,
                      __fadd_rn(__fsub_rn(y, __fmul_rn(y2, 0.5f)), q));
  if (!(a > 0.0f)) large = __int_as_float(0x7FC00000);  // nan
  if (a == 0.0f) large = -__int_as_float(0x7F800000);   // -inf
  if (a == __int_as_float(0x7F800000)) large = a;
  // -- small |x| --
  const float z2 = __fmul_rn(x, x);
  const float zero = __fmul_rn(x, 0.0f);
  float den = __fadd_rn(zero, 1.0f);
  den = fma64(den, x, 15.062909126281738);
  den = fma64(den, x, 83.04756927490234);
  den = fma64(den, x, 221.7624053955078);
  den = fma64(den, x, 309.0987243652344);
  den = fma64(den, x, 216.42788696289062);
  den = fma64(den, x, 60.11865997314453);
  float num = __fadd_rn(zero, F32(4.527000055531971e-05));
  num = fma64(num, x, 0.4985410273075104);
  num = fma64(num, x, 6.578732490539551);
  num = fma64(num, x, 29.91191864013672);
  num = fma64(num, x, 60.949668884277344);
  num = fma64(num, x, 57.11296463012695);
  num = fma64(num, x, 20.039552688598633);
  const float small = __fadd_rn(
      x, __fsub_rn(__fmul_rn(__fmul_rn(x, z2), __fdiv_rn(num, den)),
                   __fmul_rn(z2, 0.5f)));
  return fabsf(x) < F32(0.4142135679721832) ? small : large;
}

// core/prng.py::erfinv, XLA's float32 ErfInv (Giles): (central, tail)
// coefficients in Horner order
__device__ float erfinv_xla(float x) {
  constexpr double C[9][2] = {
      {2.81022636e-08, -0.000200214257}, {3.43273939e-07, 0.000100950558},
      {-3.5233877e-06, 0.00134934322},   {-4.39150654e-06, -0.00367342844},
      {0.00021858087, 0.00573950773},    {-0.00125372503, -0.0076224613},
      {-0.00417768164, 0.00943887047},   {0.246640727, 1.00167406},
      {1.50140941, 2.83297682}};
  const float lg = log1p_xla(__fmul_rn(x, -x));
  const bool lt = lg > -5.0f;
  const float w = lt ? __fsub_rn(-2.5f, lg)
                     : __fsub_rn(__double2float_rn(__dsqrt_rn(static_cast<double>(-lg))),
                                 3.0f);
  float p = F32(lt ? C[0][0] : C[0][1]);
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = fma64(p, w, static_cast<double>(F32(lt ? C[i][0] : C[i][1])));
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(x, p);
}

// core/prng.py::uniform_from_bits: the word's 23 high bits as the mantissa
// of a float in [1, 2), minus 1, scaled by one rounding, at least lo
__device__ __forceinline__ float uniform(uint32_t word, float lo, float hi) {
  const float unit = __fsub_rn(__int_as_float(static_cast<int>((word >> 9) | 0x3F800000u)),
                               1.0f);
  const float r = fma64(unit, static_cast<double>(__fsub_rn(hi, lo)),
                        static_cast<double>(lo));
  return r < lo ? lo : r;
}

// core/prng.py::normal_from_bits: sqrt(2) * erfinv(u), u uniform in
// (nextafter(-1, 0), 1)
__device__ __forceinline__ float normal(uint32_t word) {
  return __fmul_rn(F32(1.4142135623730951),
                   erfinv_xla(uniform(word, F32(-0.99999994), 1.0f)));
}

template <int KIND>
__global__ void __launch_bounds__(THREADS) threefry_kernel(const Launch p) {
  const long long total = p.n_keys * p.per_key;
  for (long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * THREADS) {
    uint32_t x1, x2;
    if (KIND != PAIRS && p.words != nullptr) {
      x1 = static_cast<uint32_t>(p.words[t]);
      x2 = 0;
    } else {
      const long long ki = p.n_keys == 1 ? 0 : t / p.per_key;
      const unsigned long long count =
          p.counts != nullptr
              ? static_cast<uint32_t>(p.counts[t * p.counts_stride])
              : static_cast<unsigned long long>(p.first + (t - ki * p.per_key));
      x1 = static_cast<uint32_t>(count >> 32);
      x2 = static_cast<uint32_t>(count);
      threefry2x32(static_cast<uint32_t>(p.key[2 * ki]),
                   static_cast<uint32_t>(p.key[2 * ki + 1]), x1, x2);
    }
    if constexpr (KIND == PAIRS) {
      reinterpret_cast<longlong2*>(p.out)[t] = make_longlong2(x1, x2);
    } else if constexpr (KIND == BITS) {
      static_cast<long long*>(p.out)[t] = x1 ^ x2;
    } else if constexpr (KIND == UNIFORM) {
      static_cast<float*>(p.out)[t] = uniform(x1 ^ x2, p.lo, p.hi);
    } else {
      static_cast<float*>(p.out)[t] = normal(x1 ^ x2);
    }
  }
}

template <int KIND>
int launch(const Launch& p, cudaStream_t stream) {
  const long long total = p.n_keys * p.per_key;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  threefry_kernel<KIND><<<static_cast<int>(blocks), THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gm2::threefry

extern "C" {

// One launch on `stream` over n_keys * per_key counts; count t is taken
// under key t / per_key (key: n_keys pairs of int64 words, each a uint32).
// Its 64-bit count is first + t % per_key, or, where `counts` is given,
// counts[t * counts_stride] cut to 32 bits (stride 0 or 1). kind 0 writes
// both threefry words to out[2t], out[2t + 1] (int64), kind 1 their xor
// (int64), kind 2 the uniform in [lo, hi) and kind 3 the normal (float32)
// of that word. Where `words` is given (kinds 1-3), word t is words[t]
// cut to 32 bits and `key` is not read. out is 16-byte aligned. Returns the
// cudaError_t of the launch; does not synchronise and allocates nothing.
int gm2_threefry(const void* key, long long n_keys, long long per_key,
                 long long first, const void* counts, long long counts_stride,
                 const void* words, int kind, float lo, float hi, void* out,
                 void* stream) {
  using namespace gm2::threefry;
  if (n_keys <= 0 || per_key <= 0 || first < 0 || out == nullptr ||
      (counts_stride != 0 && counts_stride != 1) || kind < PAIRS || kind > NORMAL ||
      (words == nullptr && key == nullptr) || (kind == PAIRS && words != nullptr) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch p{static_cast<const long long*>(key), n_keys, per_key, first,
                 static_cast<const long long*>(counts), counts_stride,
                 static_cast<const long long*>(words), lo, hi, out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case PAIRS: return launch<PAIRS>(p, st);
    case BITS: return launch<BITS>(p, st);
    case UNIFORM: return launch<UNIFORM>(p, st);
    default: return launch<NORMAL>(p, st);
  }
}

}  // extern "C"
