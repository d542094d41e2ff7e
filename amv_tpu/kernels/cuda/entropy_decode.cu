// AMV Huffman scan decode on the GPU, one thread per frame.
//
// Port of decode_scan_levels (native/entropy.c): each thread walks one
// unescaped scan with its own 64-bit bit reader held in registers and
// writes that frame's zigzag levels (slot 0 = DC difference), the
// contract of kernels/entropy_decode.py:decode_scans_device.  The four
// Huffman tables live in shared memory as a two-level LUT built by
// kernels/entropy_decode_cuda.py:build_luts:
//
//   lut1 uint16 [4][256]           indexed by the next 8 stream bits:
//       (sym << 5) | len  for a code of <= 8 bits,
//       0x8000 | slot     for the prefix of a longer code,
//       0                 for an invalid prefix;
//   lut2 uint16 [4][kSlots][256]   indexed by the 8 bits after a prefix:
//       (sym << 5) | len  (len 9..16), or 0.
//
// Tables: 0 = DC luma, 1 = DC chroma, 2 = AC luma, 3 = AC chroma.
// status[f] is 0, or -(block + 1) for the first malformed block (the
// C decoder's return code); the levels of such a frame are unspecified.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 32;  // one warp per block spreads frames over SMs
constexpr int kSlots = 8;     // second-level slots per table

struct BitReader {
  const uint32_t* words;
  int n_words;
  int pos;         // next word to load
  uint64_t cache;  // valid bits MSB-aligned, zeros below
  int bits;
};

// Keep >= 32 valid bits: enough for one code (<= 16) plus its mantissa
// (<= 15).  Past the row end the stream reads as zeros, like the C
// reader's zero fill.
__device__ __forceinline__ void refill(BitReader& br) {
  if (br.bits < 32) {
    uint32_t w = 0;
    if (br.pos < br.n_words) w = __byte_perm(__ldg(br.words + br.pos), 0, 0x0123);
    br.cache |= static_cast<uint64_t>(w) << (32 - br.bits);
    br.bits += 32;
    br.pos++;
  }
}

// Next Huffman symbol of table t: returns (sym << 5) | len, 0 if invalid.
__device__ __forceinline__ uint32_t next_code(BitReader& br, const uint16_t* l1,
                                              const uint16_t* l2, int t) {
  uint32_t peek = static_cast<uint32_t>(br.cache >> 48);
  uint32_t e = l1[t * 256 + (peek >> 8)];
  if (e & 0x8000u) e = l2[(t * kSlots + (e & 0x7FFFu)) * 256 + (peek & 0xFFu)];
  int len = static_cast<int>(e & 31u);
  br.cache <<= len;
  br.bits -= len;
  return e;
}

// n-bit mantissa with the JPEG 'extend' (n >= 1).
__device__ __forceinline__ int32_t get_xbits(BitReader& br, int n) {
  uint32_t v = static_cast<uint32_t>(br.cache >> (64 - n));
  br.cache <<= n;
  br.bits -= n;
  return v < (1u << (n - 1)) ? static_cast<int32_t>(v) - (1 << n) + 1
                             : static_cast<int32_t>(v);
}

__global__ void decode_scans_kernel(const uint32_t* __restrict__ scans,
                                    int n_frames, int n_words, int n_mcu,
                                    const uint16_t* __restrict__ lut1,
                                    const uint16_t* __restrict__ lut2,
                                    int16_t* __restrict__ levels,
                                    int32_t* __restrict__ status) {
  __shared__ uint16_t l1[4 * 256];
  __shared__ uint16_t l2[4 * kSlots * 256];
  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x) l1[i] = lut1[i];
  for (int i = threadIdx.x; i < 4 * kSlots * 256; i += blockDim.x) l2[i] = lut2[i];
  __syncthreads();

  int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_frames) return;
  BitReader br{scans + static_cast<size_t>(f) * n_words, n_words, 0, 0, 0};
  int16_t* out = levels + static_cast<size_t>(f) * n_mcu * 6 * 64;
  int rc = 0;
  int n_blocks = n_mcu * 6;
  for (int blk = 0; blk < n_blocks && rc == 0; blk++) {
    int luma = (blk % 6) < 4;
    int16_t* o = out + static_cast<size_t>(blk) * 64;
    refill(br);
    uint32_t e = next_code(br, l1, l2, luma ? 0 : 1);
    if (!(e & 31u)) { rc = -(blk + 1); break; }
    int sym = static_cast<int>(e >> 5);
    o[0] = sym ? static_cast<int16_t>(get_xbits(br, sym)) : 0;
    int i = 0;
    for (;;) {
      refill(br);
      e = next_code(br, l1, l2, luma ? 2 : 3);
      if (!(e & 31u)) { rc = -(blk + 1); break; }
      sym = static_cast<int>(e >> 5);
      if (sym == 0x00) break;  // EOB
      int run = sym >> 4, size = sym & 0xF;
      if (size == 0) {
        if (run != 15) { rc = -(blk + 1); break; }
        i += 16;               // ZRL
        continue;
      }
      int32_t level = get_xbits(br, size);
      i += run + 1;
      if (i > 63) { rc = -(blk + 1); break; }
      o[i] = static_cast<int16_t>(level);
      if (i == 63) break;      // no EOB after position 63
    }
  }
  status[f] = rc;
}

ffi::Error DecodeScansImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> scans,
                           ffi::Buffer<ffi::U16> lut1,
                           ffi::Buffer<ffi::U16> lut2,
                           ffi::ResultBuffer<ffi::S16> levels,
                           ffi::ResultBuffer<ffi::S32> status,
                           int64_t n_mcu) {
  auto dims = scans.dimensions();
  if (dims.size() != 2 || dims[1] % 4 != 0)
    return ffi::Error::InvalidArgument("scans must be [F, W] with W % 4 == 0");
  if (lut1.element_count() != 4 * 256 ||
      lut2.element_count() != 4 * kSlots * 256)
    return ffi::Error::InvalidArgument("unexpected Huffman LUT shapes");
  int n_frames = static_cast<int>(dims[0]);
  int n_words = static_cast<int>(dims[1] / 4);
  cudaError_t err = cudaMemsetAsync(levels->untyped_data(), 0,
                                    levels->size_bytes(), stream);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  if (n_frames == 0) return ffi::Error::Success();
  int grid = (n_frames + kThreads - 1) / kThreads;
  decode_scans_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(scans.typed_data()), n_frames,
      n_words, static_cast<int>(n_mcu), lut1.typed_data(), lut2.typed_data(),
      levels->typed_data(), status->typed_data());
  err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    AmvDecodeScans, DecodeScansImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()   // scans
        .Arg<ffi::Buffer<ffi::U16>>()  // lut1
        .Arg<ffi::Buffer<ffi::U16>>()  // lut2
        .Ret<ffi::Buffer<ffi::S16>>()  // levels
        .Ret<ffi::Buffer<ffi::S32>>()  // status
        .Attr<int64_t>("n_mcu"));
