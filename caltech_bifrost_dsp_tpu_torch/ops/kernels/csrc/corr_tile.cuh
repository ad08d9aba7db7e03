// The int8 tensor-core tile shared by the three correlators of sm_90a
// (corr_acc.cu, corr_triu.cu, corr_rows.cu): constants, the MMA and
// asynchronous-copy wrappers, the byte-parallel unpack and the k step of a
// warp's piece of a 128 x 128 tile pair.
//
// Operands are planes of sign-extended bytes, four time samples of one
// input to a 32-bit word, staged in shared memory as [plane][word][input]:
// a fragment register of mma.sync.m16n8k32 (s8 x s8 -> s32, exact) is four
// consecutive k bytes of one row (A) or one column (B), which is exactly
// one such word, so a lane (g = lane / 4, t = lane % 4) reads words
// [t or t + 4][g or g + 8] with no ldmatrix and no transpose.  The row
// pitch is 136 words, so the 32 lanes of a load fall on banks 8 t + g, all
// distinct.
//
// Four real products, not Karatsuba's three: vr = ar.br + ai.bi and
// vi = ai.br + (-ar).bi accumulate into TWO fragments per output tile; the
// row side stages re, im and -re (which fits a byte: -(-8) = 8), the column
// side re and im (or the row side re, im and the column re, im, -im).  A warp owns a 64 x 32 piece of the pair (4 x 4 MMA
// tiles, 2 x 64 accumulator registers a lane); 8 warps cover the pair.
//
// Packed bytes reach shared memory raw, [time][128 inputs], 16 bytes (16
// inputs of one time sample) to a cp.async; unpack_raw turns 4 time rows x
// 4 inputs into the 4 words of those inputs with __byte_perm and splits
// the nibbles into planes.  The negated plane may sit on either side
// (mma_kstep's Neg): corr_rows.cu keeps its resident row tile in two
// planes and negates the streamed column's im instead.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;           // inputs per tile side
constexpr int PITCH = TILE + 8;     // words per staged row: banks 8 t + g
constexpr int THREADS = 256;        // 2 x 4 warps of 64 x 32 outputs
constexpr int RAW_ROW = TILE / 4;   // words of one raw time row

// The tensor-core instruction and the asynchronous copies sit behind these
// functions; a host build (CBD_HOST_EMULATION, with a cuda_runtime.h that
// supplies them lane by lane) compiles the rest as C++.
#ifdef CBD_HOST_EMULATION
using cbd_emu::cp_async16;
using cbd_emu::cp_async_commit;
using cbd_emu::cp_async_wait_all;
using cbd_emu::cp_async_wait_but;
using cbd_emu::mma_m16n8k32_s8;
#else
// c[16 x 8] += a[16 x 32] b[32 x 8]; lane (g, t): a = rows g, g + 8 x
// k 4t.., rows g, g + 8 x k 16 + 4t..; b = column g x k 4t.., 16 + 4t..;
// c = rows g, g + 8 x columns 2t, 2t + 1
__device__ __forceinline__ void mma_m16n8k32_s8(int (&c)[4],
                                                const int (&a)[4],
                                                const int (&b)[2])
{
    asm(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* shared, const void* global)
{
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(shared));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(global) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_but()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
#endif

// Byte-parallel arithmetic on a word of four 4+4-bit samples.
// Sign-extend the low nibble of every byte (the high nibbles are zero).
__device__ __forceinline__ unsigned sext4x4(unsigned v)
{
    return v | ((v & 0x08080808u) * 0x1Eu);
}

// Negate every byte: ~x + 1 with no carry across bytes.
__device__ __forceinline__ unsigned neg4(unsigned x)
{
    const unsigned y = ~x;
    return ((y & 0x7F7F7F7Fu) + 0x01010101u) ^ (y & 0x80808080u);
}

// A warp's accumulators: [row MMA tile][column MMA tile][c register]
using Acc = int[4][4][4];

__device__ __forceinline__ void zero_acc(Acc& vr, Acc& vi)
{
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                vr[m][n][e] = 0;
                vi[m][n][e] = 0;
            }
        }
    }
}

// Where the minus sign of vi = ai.br - ar.bi comes from:
// NEG_A      row planes re, im, -re; column planes re, im;
// NEG_B      row planes re, im; column planes re, im, -im
//            (vi = ai.br + ar.(-bi));
// NEG_A_ALU  row and column planes re, im; -re made from the row's re
//            fragment with neg4 (a tile whose operands both lack a negated
//            plane).
enum Neg { NEG_A, NEG_B, NEG_A_ALU };

// One 32-sample k step of the warp's piece (rows row0 .., columns col0 ..
// of the staged tiles).  ``a`` is the first of the step's 8 word rows of
// the row planes (re; im at + sa; -re at + 2 sa with NEG_A), ``b`` that of
// the column planes (re; im at + sb; -im at + 2 sb with NEG_B).
template <int NEG>
__device__ __forceinline__ void mma_kstep(const int* __restrict__ a, int sa,
                                          const int* __restrict__ b, int sb,
                                          int row0, int col0, int lane,
                                          Acc& vr, Acc& vi)
{
    const int g = lane >> 2;
    const int t = lane & 3;
    // words t and t + 4 of this k step
    const int* alo = a + t * PITCH;
    const int* ahi = alo + 4 * PITCH;
    const int* blo = b + t * PITCH;
    const int* bhi = blo + 4 * PITCH;
    int br[4][2], bi[4][2], bn[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
        const int col = col0 + n * 8 + g;
        br[n][0] = blo[col];
        br[n][1] = bhi[col];
        bi[n][0] = blo[sb + col];
        bi[n][1] = bhi[sb + col];
        if constexpr (NEG == NEG_B) {
            bn[n][0] = blo[2 * sb + col];
            bn[n][1] = bhi[2 * sb + col];
        }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const int row = row0 + m * 16 + g;
        int ap[3][4];
#pragma unroll
        for (int pl = 0; pl < (NEG == NEG_A ? 3 : 2); ++pl) {
            ap[pl][0] = alo[pl * sa + row];
            ap[pl][1] = alo[pl * sa + row + 8];
            ap[pl][2] = ahi[pl * sa + row];
            ap[pl][3] = ahi[pl * sa + row + 8];
        }
        if constexpr (NEG == NEG_A_ALU) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                ap[2][r] = static_cast<int>(neg4(static_cast<unsigned>(
                    ap[0][r])));
            }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            mma_m16n8k32_s8(vr[m][n], ap[0], br[n]);
            mma_m16n8k32_s8(vr[m][n], ap[1], bi[n]);
            mma_m16n8k32_s8(vi[m][n], ap[1], br[n]);
            if constexpr (NEG == NEG_B) {
                mma_m16n8k32_s8(vi[m][n], ap[0], bn[n]);
            } else {
                mma_m16n8k32_s8(vi[m][n], ap[2], bi[n]);
            }
        }
    }
}

// Stage NT time rows of one tile's packed bytes: raw[r][w] holds inputs
// 4 w .. 4 w + 3 of time row r of ``src`` (row r at src + r * stride_t).
// Rows at or past ``nt`` and inputs at or past ``nin`` read as zero and are
// never touched.  With ``vec16`` (src and stride_t 16-byte aligned) each
// whole 16-input vector is one cp.async; otherwise, and for a vector that
// ``nin`` cuts, the bytes are loaded one by one and stored with st.shared.
// The caller commits the group.
template <int NT>
__device__ __forceinline__ void stage_raw(int* __restrict__ raw,
                                          const uint8_t* __restrict__ src,
                                          long long stride_t, int nt, int nin,
                                          bool vec16, int tid)
{
    for (int item = tid; item < NT * 8; item += THREADS) {
        const int r = item >> 3;
        const int v = (item & 7) * 16;
        int4* dst = reinterpret_cast<int4*>(raw + r * RAW_ROW + v / 4);
        if (r >= nt || v >= nin) {
            *dst = int4{0, 0, 0, 0};
            continue;
        }
        const uint8_t* s = src + r * stride_t + v;
        if (vec16 && v + 16 <= nin) {
            cp_async16(dst, s);
            continue;
        }
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            if (v + k < nin) {
                w[k >> 2] |= static_cast<unsigned>(s[k]) << (8 * (k & 3));
            }
        }
        *dst = int4{static_cast<int>(w[0]), static_cast<int>(w[1]),
                    static_cast<int>(w[2]), static_cast<int>(w[3])};
    }
}

__device__ __forceinline__ void store4(int* dst, const unsigned (&w)[4])
{
    *reinterpret_cast<int4*>(dst) = int4{
        static_cast<int>(w[0]), static_cast<int>(w[1]),
        static_cast<int>(w[2]), static_cast<int>(w[3])};
}

// The planes unpack_raw writes, ``plane_words`` apart: re, im, and -re or
// -im or neither.
enum Planes { RE_IM, RE_IM_NRE, RE_IM_NIM };

// Unpack NT staged time rows (NT / 4 words per input) into PLANES at
// ``planes``: word q of input k at planes + q * PITCH + k.
template <int NT, int PLANES>
__device__ __forceinline__ void unpack_raw(const int* __restrict__ raw,
                                           int* __restrict__ planes,
                                           int plane_words, int tid)
{
    for (int item = tid; item < NT / 4 * RAW_ROW; item += THREADS) {
        const int q = item / RAW_ROW;
        const int g = item - q * RAW_ROW;
        // byte k of w_u: input 4 g + k at time 4 q + u
        const unsigned* r = reinterpret_cast<const unsigned*>(raw)
            + 4 * q * RAW_ROW + g;
        const unsigned w0 = r[0];
        const unsigned w1 = r[RAW_ROW];
        const unsigned w2 = r[2 * RAW_ROW];
        const unsigned w3 = r[3 * RAW_ROW];
        // transpose the 4 x 4 bytes: x[k] byte u = w_u byte k
        const unsigned lo01 = __byte_perm(w0, w1, 0x5140u);
        const unsigned hi01 = __byte_perm(w0, w1, 0x7362u);
        const unsigned lo23 = __byte_perm(w2, w3, 0x5140u);
        const unsigned hi23 = __byte_perm(w2, w3, 0x7362u);
        const unsigned x[4] = {__byte_perm(lo01, lo23, 0x5410u),
                               __byte_perm(lo01, lo23, 0x7632u),
                               __byte_perm(hi01, hi23, 0x5410u),
                               __byte_perm(hi01, hi23, 0x7632u)};
        unsigned re[4], im[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            re[k] = sext4x4((x[k] >> 4) & 0x0F0F0F0Fu);
            im[k] = sext4x4(x[k] & 0x0F0F0F0Fu);
        }
        int* d = planes + q * PITCH + 4 * g;
        store4(d, re);
        store4(d + plane_words, im);
        if constexpr (PLANES != RE_IM) {
            unsigned neg[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                neg[k] = neg4(PLANES == RE_IM_NRE ? re[k] : im[k]);
            }
            store4(d + 2 * plane_words, neg);
        }
    }
}

// Write the warp's piece (rows i0 .., columns j0 ..) into one channel's
// planes [ninput][ninput], or with ``add`` the sums of it and what they
// hold: every addend is loaded into the accumulators before the first
// store, so the loads are in flight together.  A lane's two columns 2t,
// 2t + 1 go as one 8-byte access where ninput is even (then both exist and
// the pair is aligned); entries past ninput are skipped.
__device__ __forceinline__ void store_piece(Acc& vr, Acc& vi,
                                            int* __restrict__ out_r,
                                            int* __restrict__ out_i, int i0,
                                            int j0, int ninput, int lane,
                                            bool add)
{
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool pairs = (ninput & 1) == 0;
    for (int pass = add ? 0 : 1; pass < 2; ++pass) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
            for (int n = 0; n < 4; ++n) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int i = i0 + m * 16 + g + h * 8;
                    const int j = j0 + n * 8 + 2 * t;
                    if (i >= ninput || j >= ninput) continue;
                    const long long o = static_cast<long long>(i) * ninput
                        + j;
                    int* r = vr[m][n] + 2 * h;
                    int* s = vi[m][n] + 2 * h;
                    if (pairs) {
                        int2* pr = reinterpret_cast<int2*>(out_r + o);
                        int2* pi = reinterpret_cast<int2*>(out_i + o);
                        if (pass == 0) {
                            const int2 ar = *pr;
                            const int2 ai = *pi;
                            r[0] += ar.x;
                            r[1] += ar.y;
                            s[0] += ai.x;
                            s[1] += ai.y;
                        } else {
                            *pr = int2{r[0], r[1]};
                            *pi = int2{s[0], s[1]};
                        }
                        continue;
                    }
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        if (j + u >= ninput) continue;
                        if (pass == 0) {
                            r[u] += out_r[o + u];
                            s[u] += out_i[o + u];
                        } else {
                            out_r[o + u] = r[u];
                            out_i[o + u] = s[u];
                        }
                    }
                }
            }
        }
    }
}

}  // namespace
