// The pruned median-selection networks of K7's network form
// (median_pool.cu), k = 1..8. Generated from the port's
// ops/median_pool.py: median_net_table(k); rewrite it with
//     python -m <port package>.ops.median_pool
// and do not edit it by hand.
//
// v[0 .. n-1] holds the n = k * k values of a k x k window in window
// order, row by row. The comparators are those of Batcher's odd-even
// merge sort of the next power of two, with the +inf padding folded
// away and only output (n - 1) / 2's backward cone kept.
// median_ce(v[a], v[b]) leaves the minimum in v[a] and the maximum in
// v[b]; median_lo and median_hi compute only the half that the median
// reads (the minimum into v[a], the maximum into v[b]). After
// median_net<K>::run(v), v[median_net<K>::out] is the lower median.
// Every index is a literal, so v lives in registers.

#pragma once

__device__ __forceinline__ void median_ce(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}
__device__ __forceinline__ void median_lo(float& a, float b) {
  a = fminf(a, b);
}
__device__ __forceinline__ void median_hi(float a, float& b) {
  b = fmaxf(a, b);
}

template <int K>
struct median_net;

template <>
struct median_net<1> {
  static constexpr int n = 1, out = 0, comparators = 0, minmax = 0;
  static __device__ __forceinline__ void run(float (&)[1]) {
  }
};

template <>
struct median_net<2> {
  static constexpr int n = 4, out = 1, comparators = 5, minmax = 7;
  static __device__ __forceinline__ void run(float (&v)[4]) {
    median_ce(v[0], v[1]); median_ce(v[2], v[3]); median_hi(v[0], v[2]);
    median_lo(v[1], v[3]); median_lo(v[1], v[2]);
  }
};

template <>
struct median_net<3> {
  static constexpr int n = 9, out = 4, comparators = 24, minmax = 40;
  static __device__ __forceinline__ void run(float (&v)[9]) {
    median_ce(v[0], v[1]); median_ce(v[2], v[3]); median_ce(v[4], v[5]);
    median_ce(v[6], v[7]); median_ce(v[0], v[2]); median_ce(v[1], v[3]);
    median_ce(v[4], v[6]); median_ce(v[5], v[7]); median_ce(v[1], v[2]);
    median_ce(v[5], v[6]); median_ce(v[0], v[4]); median_ce(v[1], v[5]);
    median_ce(v[2], v[6]); median_lo(v[3], v[7]); median_ce(v[2], v[4]);
    median_ce(v[3], v[5]); median_hi(v[1], v[2]); median_ce(v[3], v[4]);
    median_lo(v[5], v[6]); median_hi(v[0], v[8]); median_lo(v[4], v[8]);
    median_hi(v[2], v[4]); median_lo(v[3], v[5]); median_hi(v[3], v[4]);
  }
};

template <>
struct median_net<4> {
  static constexpr int n = 16, out = 7, comparators = 53, minmax = 91;
  static __device__ __forceinline__ void run(float (&v)[16]) {
    median_ce(v[0], v[1]); median_ce(v[2], v[3]); median_ce(v[4], v[5]);
    median_ce(v[6], v[7]); median_ce(v[8], v[9]); median_ce(v[10], v[11]);
    median_ce(v[12], v[13]); median_ce(v[14], v[15]); median_ce(v[0], v[2]);
    median_ce(v[1], v[3]); median_ce(v[4], v[6]); median_ce(v[5], v[7]);
    median_ce(v[8], v[10]); median_ce(v[9], v[11]); median_ce(v[12], v[14]);
    median_ce(v[13], v[15]); median_ce(v[1], v[2]); median_ce(v[5], v[6]);
    median_ce(v[9], v[10]); median_ce(v[13], v[14]); median_ce(v[0], v[4]);
    median_ce(v[1], v[5]); median_ce(v[2], v[6]); median_ce(v[3], v[7]);
    median_ce(v[8], v[12]); median_ce(v[9], v[13]); median_ce(v[10], v[14]);
    median_ce(v[11], v[15]); median_ce(v[2], v[4]); median_ce(v[3], v[5]);
    median_ce(v[10], v[12]); median_ce(v[11], v[13]); median_ce(v[1], v[2]);
    median_ce(v[3], v[4]); median_ce(v[5], v[6]); median_ce(v[9], v[10]);
    median_ce(v[11], v[12]); median_ce(v[13], v[14]); median_hi(v[0], v[8]);
    median_hi(v[1], v[9]); median_hi(v[2], v[10]); median_hi(v[3], v[11]);
    median_lo(v[4], v[12]); median_lo(v[5], v[13]); median_lo(v[6], v[14]);
    median_lo(v[7], v[15]); median_hi(v[4], v[8]); median_hi(v[5], v[9]);
    median_lo(v[6], v[10]); median_lo(v[7], v[11]); median_hi(v[6], v[8]);
    median_lo(v[7], v[9]); median_lo(v[7], v[8]);
  }
};

template <>
struct median_net<5> {
  static constexpr int n = 25, out = 12, comparators = 113, minmax = 202;
  static __device__ __forceinline__ void run(float (&v)[25]) {
    median_ce(v[0], v[1]); median_ce(v[2], v[3]); median_ce(v[4], v[5]);
    median_ce(v[6], v[7]); median_ce(v[8], v[9]); median_ce(v[10], v[11]);
    median_ce(v[12], v[13]); median_ce(v[14], v[15]); median_ce(v[16], v[17]);
    median_ce(v[18], v[19]); median_ce(v[20], v[21]); median_ce(v[22], v[23]);
    median_ce(v[0], v[2]); median_ce(v[1], v[3]); median_ce(v[4], v[6]);
    median_ce(v[5], v[7]); median_ce(v[8], v[10]); median_ce(v[9], v[11]);
    median_ce(v[12], v[14]); median_ce(v[13], v[15]); median_ce(v[16], v[18]);
    median_ce(v[17], v[19]); median_ce(v[20], v[22]); median_ce(v[21], v[23]);
    median_ce(v[1], v[2]); median_ce(v[5], v[6]); median_ce(v[9], v[10]);
    median_ce(v[13], v[14]); median_ce(v[17], v[18]); median_ce(v[21], v[22]);
    median_ce(v[0], v[4]); median_ce(v[1], v[5]); median_ce(v[2], v[6]);
    median_ce(v[3], v[7]); median_ce(v[8], v[12]); median_ce(v[9], v[13]);
    median_ce(v[10], v[14]); median_ce(v[11], v[15]); median_ce(v[16], v[20]);
    median_ce(v[17], v[21]); median_ce(v[18], v[22]); median_ce(v[19], v[23]);
    median_ce(v[2], v[4]); median_ce(v[3], v[5]); median_ce(v[10], v[12]);
    median_ce(v[11], v[13]); median_ce(v[18], v[20]); median_ce(v[19], v[21]);
    median_ce(v[1], v[2]); median_ce(v[3], v[4]); median_ce(v[5], v[6]);
    median_ce(v[9], v[10]); median_ce(v[11], v[12]); median_ce(v[13], v[14]);
    median_ce(v[17], v[18]); median_ce(v[19], v[20]); median_ce(v[21], v[22]);
    median_ce(v[0], v[8]); median_ce(v[1], v[9]); median_ce(v[2], v[10]);
    median_ce(v[3], v[11]); median_ce(v[4], v[12]); median_ce(v[5], v[13]);
    median_ce(v[6], v[14]); median_lo(v[7], v[15]); median_ce(v[16], v[24]);
    median_ce(v[4], v[8]); median_ce(v[5], v[9]); median_ce(v[6], v[10]);
    median_ce(v[7], v[11]); median_ce(v[20], v[24]); median_ce(v[2], v[4]);
    median_ce(v[3], v[5]); median_ce(v[6], v[8]); median_ce(v[7], v[9]);
    median_ce(v[10], v[12]); median_ce(v[11], v[13]); median_ce(v[18], v[20]);
    median_ce(v[19], v[21]); median_ce(v[22], v[24]); median_ce(v[1], v[2]);
    median_ce(v[3], v[4]); median_ce(v[5], v[6]); median_ce(v[7], v[8]);
    median_ce(v[9], v[10]); median_ce(v[11], v[12]); median_lo(v[13], v[14]);
    median_ce(v[17], v[18]); median_ce(v[19], v[20]); median_ce(v[21], v[22]);
    median_ce(v[23], v[24]); median_hi(v[0], v[16]); median_hi(v[1], v[17]);
    median_hi(v[2], v[18]); median_hi(v[3], v[19]); median_hi(v[4], v[20]);
    median_hi(v[5], v[21]); median_lo(v[6], v[22]); median_lo(v[7], v[23]);
    median_lo(v[8], v[24]); median_hi(v[8], v[16]); median_hi(v[9], v[17]);
    median_lo(v[10], v[18]); median_lo(v[11], v[19]); median_lo(v[12], v[20]);
    median_lo(v[13], v[21]); median_hi(v[6], v[10]); median_hi(v[7], v[11]);
    median_lo(v[12], v[16]); median_lo(v[13], v[17]); median_hi(v[10], v[12]);
    median_lo(v[11], v[13]); median_hi(v[11], v[12]);
  }
};

template <>
struct median_net<6> {
  static constexpr int n = 36, out = 17, comparators = 214, minmax = 393;
  static __device__ __forceinline__ void run(float (&v)[36]) {
    median_ce(v[0], v[1]); median_ce(v[2], v[3]); median_ce(v[4], v[5]);
    median_ce(v[6], v[7]); median_ce(v[8], v[9]); median_ce(v[10], v[11]);
    median_ce(v[12], v[13]); median_ce(v[14], v[15]); median_ce(v[16], v[17]);
    median_ce(v[18], v[19]); median_ce(v[20], v[21]); median_ce(v[22], v[23]);
    median_ce(v[24], v[25]); median_ce(v[26], v[27]); median_ce(v[28], v[29]);
    median_ce(v[30], v[31]); median_ce(v[32], v[33]); median_ce(v[34], v[35]);
    median_ce(v[0], v[2]); median_ce(v[1], v[3]); median_ce(v[4], v[6]);
    median_ce(v[5], v[7]); median_ce(v[8], v[10]); median_ce(v[9], v[11]);
    median_ce(v[12], v[14]); median_ce(v[13], v[15]); median_ce(v[16], v[18]);
    median_ce(v[17], v[19]); median_ce(v[20], v[22]); median_ce(v[21], v[23]);
    median_ce(v[24], v[26]); median_ce(v[25], v[27]); median_ce(v[28], v[30]);
    median_ce(v[29], v[31]); median_ce(v[32], v[34]); median_ce(v[33], v[35]);
    median_ce(v[1], v[2]); median_ce(v[5], v[6]); median_ce(v[9], v[10]);
    median_ce(v[13], v[14]); median_ce(v[17], v[18]); median_ce(v[21], v[22]);
    median_ce(v[25], v[26]); median_ce(v[29], v[30]); median_ce(v[33], v[34]);
    median_ce(v[0], v[4]); median_ce(v[1], v[5]); median_ce(v[2], v[6]);
    median_ce(v[3], v[7]); median_ce(v[8], v[12]); median_ce(v[9], v[13]);
    median_ce(v[10], v[14]); median_ce(v[11], v[15]); median_ce(v[16], v[20]);
    median_ce(v[17], v[21]); median_ce(v[18], v[22]); median_ce(v[19], v[23]);
    median_ce(v[24], v[28]); median_ce(v[25], v[29]); median_ce(v[26], v[30]);
    median_ce(v[27], v[31]); median_ce(v[2], v[4]); median_ce(v[3], v[5]);
    median_ce(v[10], v[12]); median_ce(v[11], v[13]); median_ce(v[18], v[20]);
    median_ce(v[19], v[21]); median_ce(v[26], v[28]); median_ce(v[27], v[29]);
    median_ce(v[1], v[2]); median_ce(v[3], v[4]); median_ce(v[5], v[6]);
    median_ce(v[9], v[10]); median_ce(v[11], v[12]); median_ce(v[13], v[14]);
    median_ce(v[17], v[18]); median_ce(v[19], v[20]); median_ce(v[21], v[22]);
    median_ce(v[25], v[26]); median_ce(v[27], v[28]); median_ce(v[29], v[30]);
    median_ce(v[33], v[34]); median_ce(v[0], v[8]); median_ce(v[1], v[9]);
    median_ce(v[2], v[10]); median_ce(v[3], v[11]); median_ce(v[4], v[12]);
    median_ce(v[5], v[13]); median_ce(v[6], v[14]); median_ce(v[7], v[15]);
    median_ce(v[16], v[24]); median_ce(v[17], v[25]); median_ce(v[18], v[26]);
    median_ce(v[19], v[27]); median_ce(v[20], v[28]); median_ce(v[21], v[29]);
    median_ce(v[22], v[30]); median_ce(v[23], v[31]); median_ce(v[4], v[8]);
    median_ce(v[5], v[9]); median_ce(v[6], v[10]); median_ce(v[7], v[11]);
    median_ce(v[20], v[24]); median_ce(v[21], v[25]); median_ce(v[22], v[26]);
    median_ce(v[23], v[27]); median_ce(v[2], v[4]); median_ce(v[3], v[5]);
    median_ce(v[6], v[8]); median_ce(v[7], v[9]); median_ce(v[10], v[12]);
    median_ce(v[11], v[13]); median_ce(v[18], v[20]); median_ce(v[19], v[21]);
    median_ce(v[22], v[24]); median_ce(v[23], v[25]); median_ce(v[26], v[28]);
    median_ce(v[27], v[29]); median_ce(v[1], v[2]); median_ce(v[3], v[4]);
    median_ce(v[5], v[6]); median_ce(v[7], v[8]); median_ce(v[9], v[10]);
    median_ce(v[11], v[12]); median_ce(v[13], v[14]); median_ce(v[17], v[18]);
    median_ce(v[19], v[20]); median_ce(v[21], v[22]); median_ce(v[23], v[24]);
    median_ce(v[25], v[26]); median_ce(v[27], v[28]); median_ce(v[29], v[30]);
    median_ce(v[33], v[34]); median_ce(v[0], v[16]); median_ce(v[1], v[17]);
    median_ce(v[2], v[18]); median_ce(v[3], v[19]); median_ce(v[4], v[20]);
    median_ce(v[5], v[21]); median_ce(v[6], v[22]); median_ce(v[7], v[23]);
    median_ce(v[8], v[24]); median_ce(v[9], v[25]); median_ce(v[10], v[26]);
    median_ce(v[11], v[27]); median_lo(v[12], v[28]); median_lo(v[13], v[29]);
    median_lo(v[14], v[30]); median_lo(v[15], v[31]); median_ce(v[8], v[16]);
    median_ce(v[9], v[17]); median_ce(v[10], v[18]); median_ce(v[11], v[19]);
    median_ce(v[12], v[20]); median_ce(v[13], v[21]); median_ce(v[14], v[22]);
    median_ce(v[15], v[23]); median_lo(v[4], v[8]); median_ce(v[5], v[9]);
    median_hi(v[6], v[10]); median_ce(v[7], v[11]); median_ce(v[12], v[16]);
    median_ce(v[13], v[17]); median_ce(v[14], v[18]); median_ce(v[15], v[19]);
    median_ce(v[20], v[24]); median_ce(v[21], v[25]); median_lo(v[22], v[26]);
    median_lo(v[23], v[27]); median_ce(v[2], v[4]); median_lo(v[3], v[5]);
    median_hi(v[7], v[9]); median_ce(v[10], v[12]); median_ce(v[11], v[13]);
    median_ce(v[14], v[16]); median_ce(v[15], v[17]); median_ce(v[18], v[20]);
    median_ce(v[19], v[21]); median_ce(v[22], v[24]); median_lo(v[23], v[25]);
    median_ce(v[1], v[2]); median_lo(v[3], v[4]); median_ce(v[9], v[10]);
    median_ce(v[11], v[12]); median_ce(v[13], v[14]); median_ce(v[15], v[16]);
    median_ce(v[17], v[18]); median_ce(v[19], v[20]); median_ce(v[21], v[22]);
    median_ce(v[23], v[24]); median_ce(v[33], v[34]); median_hi(v[0], v[32]);
    median_hi(v[1], v[33]); median_hi(v[2], v[34]); median_hi(v[3], v[35]);
    median_hi(v[16], v[32]); median_lo(v[17], v[33]); median_lo(v[18], v[34]);
    median_lo(v[19], v[35]); median_hi(v[9], v[17]); median_hi(v[10], v[18]);
    median_hi(v[11], v[19]); median_hi(v[12], v[20]); median_lo(v[13], v[21]);
    median_lo(v[14], v[22]); median_lo(v[15], v[23]); median_lo(v[24], v[32]);
    median_hi(v[13], v[17]); median_hi(v[14], v[18]); median_lo(v[15], v[19]);
    median_lo(v[20], v[24]); median_hi(v[15], v[17]); median_lo(v[18], v[20]);
    median_lo(v[17], v[18]);
  }
};

template <>
struct median_net<7> {
  static constexpr int n = 49, out = 24, comparators = 319, minmax = 590;
  static __device__ __forceinline__ void run(float (&v)[49]) {
    median_ce(v[0], v[1]); median_ce(v[2], v[3]); median_ce(v[4], v[5]);
    median_ce(v[6], v[7]); median_ce(v[8], v[9]); median_ce(v[10], v[11]);
    median_ce(v[12], v[13]); median_ce(v[14], v[15]); median_ce(v[16], v[17]);
    median_ce(v[18], v[19]); median_ce(v[20], v[21]); median_ce(v[22], v[23]);
    median_ce(v[24], v[25]); median_ce(v[26], v[27]); median_ce(v[28], v[29]);
    median_ce(v[30], v[31]); median_ce(v[32], v[33]); median_ce(v[34], v[35]);
    median_ce(v[36], v[37]); median_ce(v[38], v[39]); median_ce(v[40], v[41]);
    median_ce(v[42], v[43]); median_ce(v[44], v[45]); median_ce(v[46], v[47]);
    median_ce(v[0], v[2]); median_ce(v[1], v[3]); median_ce(v[4], v[6]);
    median_ce(v[5], v[7]); median_ce(v[8], v[10]); median_ce(v[9], v[11]);
    median_ce(v[12], v[14]); median_ce(v[13], v[15]); median_ce(v[16], v[18]);
    median_ce(v[17], v[19]); median_ce(v[20], v[22]); median_ce(v[21], v[23]);
    median_ce(v[24], v[26]); median_ce(v[25], v[27]); median_ce(v[28], v[30]);
    median_ce(v[29], v[31]); median_ce(v[32], v[34]); median_ce(v[33], v[35]);
    median_ce(v[36], v[38]); median_ce(v[37], v[39]); median_ce(v[40], v[42]);
    median_ce(v[41], v[43]); median_ce(v[44], v[46]); median_ce(v[45], v[47]);
    median_ce(v[1], v[2]); median_ce(v[5], v[6]); median_ce(v[9], v[10]);
    median_ce(v[13], v[14]); median_ce(v[17], v[18]); median_ce(v[21], v[22]);
    median_ce(v[25], v[26]); median_ce(v[29], v[30]); median_ce(v[33], v[34]);
    median_ce(v[37], v[38]); median_ce(v[41], v[42]); median_ce(v[45], v[46]);
    median_ce(v[0], v[4]); median_ce(v[1], v[5]); median_ce(v[2], v[6]);
    median_ce(v[3], v[7]); median_ce(v[8], v[12]); median_ce(v[9], v[13]);
    median_ce(v[10], v[14]); median_ce(v[11], v[15]); median_ce(v[16], v[20]);
    median_ce(v[17], v[21]); median_ce(v[18], v[22]); median_ce(v[19], v[23]);
    median_ce(v[24], v[28]); median_ce(v[25], v[29]); median_ce(v[26], v[30]);
    median_ce(v[27], v[31]); median_ce(v[32], v[36]); median_ce(v[33], v[37]);
    median_ce(v[34], v[38]); median_ce(v[35], v[39]); median_ce(v[40], v[44]);
    median_ce(v[41], v[45]); median_ce(v[42], v[46]); median_ce(v[43], v[47]);
    median_ce(v[2], v[4]); median_ce(v[3], v[5]); median_ce(v[10], v[12]);
    median_ce(v[11], v[13]); median_ce(v[18], v[20]); median_ce(v[19], v[21]);
    median_ce(v[26], v[28]); median_ce(v[27], v[29]); median_ce(v[34], v[36]);
    median_ce(v[35], v[37]); median_ce(v[42], v[44]); median_ce(v[43], v[45]);
    median_ce(v[1], v[2]); median_ce(v[3], v[4]); median_ce(v[5], v[6]);
    median_ce(v[9], v[10]); median_ce(v[11], v[12]); median_ce(v[13], v[14]);
    median_ce(v[17], v[18]); median_ce(v[19], v[20]); median_ce(v[21], v[22]);
    median_ce(v[25], v[26]); median_ce(v[27], v[28]); median_ce(v[29], v[30]);
    median_ce(v[33], v[34]); median_ce(v[35], v[36]); median_ce(v[37], v[38]);
    median_ce(v[41], v[42]); median_ce(v[43], v[44]); median_ce(v[45], v[46]);
    median_ce(v[0], v[8]); median_ce(v[1], v[9]); median_ce(v[2], v[10]);
    median_ce(v[3], v[11]); median_ce(v[4], v[12]); median_ce(v[5], v[13]);
    median_ce(v[6], v[14]); median_ce(v[7], v[15]); median_ce(v[16], v[24]);
    median_ce(v[17], v[25]); median_ce(v[18], v[26]); median_ce(v[19], v[27]);
    median_ce(v[20], v[28]); median_ce(v[21], v[29]); median_ce(v[22], v[30]);
    median_ce(v[23], v[31]); median_ce(v[32], v[40]); median_ce(v[33], v[41]);
    median_ce(v[34], v[42]); median_ce(v[35], v[43]); median_ce(v[36], v[44]);
    median_ce(v[37], v[45]); median_ce(v[38], v[46]); median_ce(v[39], v[47]);
    median_ce(v[4], v[8]); median_ce(v[5], v[9]); median_ce(v[6], v[10]);
    median_ce(v[7], v[11]); median_ce(v[20], v[24]); median_ce(v[21], v[25]);
    median_ce(v[22], v[26]); median_ce(v[23], v[27]); median_ce(v[36], v[40]);
    median_ce(v[37], v[41]); median_ce(v[38], v[42]); median_ce(v[39], v[43]);
    median_ce(v[2], v[4]); median_ce(v[3], v[5]); median_ce(v[6], v[8]);
    median_ce(v[7], v[9]); median_ce(v[10], v[12]); median_ce(v[11], v[13]);
    median_ce(v[18], v[20]); median_ce(v[19], v[21]); median_ce(v[22], v[24]);
    median_ce(v[23], v[25]); median_ce(v[26], v[28]); median_ce(v[27], v[29]);
    median_ce(v[34], v[36]); median_ce(v[35], v[37]); median_ce(v[38], v[40]);
    median_ce(v[39], v[41]); median_ce(v[42], v[44]); median_ce(v[43], v[45]);
    median_ce(v[1], v[2]); median_ce(v[3], v[4]); median_ce(v[5], v[6]);
    median_ce(v[7], v[8]); median_ce(v[9], v[10]); median_ce(v[11], v[12]);
    median_ce(v[13], v[14]); median_ce(v[17], v[18]); median_ce(v[19], v[20]);
    median_ce(v[21], v[22]); median_ce(v[23], v[24]); median_ce(v[25], v[26]);
    median_ce(v[27], v[28]); median_ce(v[29], v[30]); median_ce(v[33], v[34]);
    median_ce(v[35], v[36]); median_ce(v[37], v[38]); median_ce(v[39], v[40]);
    median_ce(v[41], v[42]); median_ce(v[43], v[44]); median_ce(v[45], v[46]);
    median_ce(v[0], v[16]); median_ce(v[1], v[17]); median_ce(v[2], v[18]);
    median_ce(v[3], v[19]); median_ce(v[4], v[20]); median_ce(v[5], v[21]);
    median_ce(v[6], v[22]); median_ce(v[7], v[23]); median_ce(v[8], v[24]);
    median_ce(v[9], v[25]); median_ce(v[10], v[26]); median_ce(v[11], v[27]);
    median_ce(v[12], v[28]); median_ce(v[13], v[29]); median_lo(v[14], v[30]);
    median_lo(v[15], v[31]); median_ce(v[32], v[48]); median_ce(v[8], v[16]);
    median_ce(v[9], v[17]); median_ce(v[10], v[18]); median_ce(v[11], v[19]);
    median_ce(v[12], v[20]); median_ce(v[13], v[21]); median_ce(v[14], v[22]);
    median_ce(v[15], v[23]); median_ce(v[40], v[48]); median_ce(v[4], v[8]);
    median_ce(v[5], v[9]); median_ce(v[6], v[10]); median_ce(v[7], v[11]);
    median_ce(v[12], v[16]); median_ce(v[13], v[17]); median_ce(v[14], v[18]);
    median_ce(v[15], v[19]); median_ce(v[20], v[24]); median_ce(v[21], v[25]);
    median_ce(v[22], v[26]); median_ce(v[23], v[27]); median_ce(v[36], v[40]);
    median_ce(v[37], v[41]); median_ce(v[38], v[42]); median_ce(v[39], v[43]);
    median_ce(v[44], v[48]); median_ce(v[2], v[4]); median_ce(v[3], v[5]);
    median_ce(v[6], v[8]); median_ce(v[7], v[9]); median_ce(v[10], v[12]);
    median_ce(v[11], v[13]); median_ce(v[14], v[16]); median_ce(v[15], v[17]);
    median_ce(v[18], v[20]); median_ce(v[19], v[21]); median_ce(v[22], v[24]);
    median_ce(v[23], v[25]); median_ce(v[26], v[28]); median_lo(v[27], v[29]);
    median_ce(v[34], v[36]); median_ce(v[35], v[37]); median_ce(v[38], v[40]);
    median_ce(v[39], v[41]); median_ce(v[42], v[44]); median_ce(v[43], v[45]);
    median_ce(v[46], v[48]); median_ce(v[1], v[2]); median_ce(v[3], v[4]);
    median_ce(v[5], v[6]); median_ce(v[7], v[8]); median_ce(v[9], v[10]);
    median_ce(v[11], v[12]); median_ce(v[13], v[14]); median_ce(v[15], v[16]);
    median_ce(v[17], v[18]); median_ce(v[19], v[20]); median_ce(v[21], v[22]);
    median_ce(v[23], v[24]); median_ce(v[25], v[26]); median_lo(v[27], v[28]);
    median_ce(v[33], v[34]); median_ce(v[35], v[36]); median_ce(v[37], v[38]);
    median_ce(v[39], v[40]); median_ce(v[41], v[42]); median_ce(v[43], v[44]);
    median_ce(v[45], v[46]); median_ce(v[47], v[48]); median_hi(v[0], v[32]);
    median_hi(v[1], v[33]); median_hi(v[2], v[34]); median_hi(v[3], v[35]);
    median_hi(v[4], v[36]); median_hi(v[5], v[37]); median_hi(v[6], v[38]);
    median_hi(v[7], v[39]); median_hi(v[8], v[40]); median_hi(v[9], v[41]);
    median_hi(v[10], v[42]); median_hi(v[11], v[43]); median_lo(v[12], v[44]);
    median_lo(v[13], v[45]); median_lo(v[14], v[46]); median_lo(v[15], v[47]);
    median_lo(v[16], v[48]); median_hi(v[16], v[32]); median_hi(v[17], v[33]);
    median_hi(v[18], v[34]); median_hi(v[19], v[35]); median_lo(v[20], v[36]);
    median_lo(v[21], v[37]); median_lo(v[22], v[38]); median_lo(v[23], v[39]);
    median_lo(v[24], v[40]); median_lo(v[25], v[41]); median_lo(v[26], v[42]);
    median_lo(v[27], v[43]); median_hi(v[12], v[20]); median_hi(v[13], v[21]);
    median_hi(v[14], v[22]); median_hi(v[15], v[23]); median_lo(v[24], v[32]);
    median_lo(v[25], v[33]); median_lo(v[26], v[34]); median_lo(v[27], v[35]);
    median_hi(v[20], v[24]); median_hi(v[21], v[25]); median_lo(v[22], v[26]);
    median_lo(v[23], v[27]); median_hi(v[22], v[24]); median_lo(v[23], v[25]);
    median_hi(v[23], v[24]);
  }
};

template <>
struct median_net<8> {
  static constexpr int n = 64, out = 31, comparators = 445, minmax = 827;
  static __device__ __forceinline__ void run(float (&v)[64]) {
    median_ce(v[0], v[1]); median_ce(v[2], v[3]); median_ce(v[4], v[5]);
    median_ce(v[6], v[7]); median_ce(v[8], v[9]); median_ce(v[10], v[11]);
    median_ce(v[12], v[13]); median_ce(v[14], v[15]); median_ce(v[16], v[17]);
    median_ce(v[18], v[19]); median_ce(v[20], v[21]); median_ce(v[22], v[23]);
    median_ce(v[24], v[25]); median_ce(v[26], v[27]); median_ce(v[28], v[29]);
    median_ce(v[30], v[31]); median_ce(v[32], v[33]); median_ce(v[34], v[35]);
    median_ce(v[36], v[37]); median_ce(v[38], v[39]); median_ce(v[40], v[41]);
    median_ce(v[42], v[43]); median_ce(v[44], v[45]); median_ce(v[46], v[47]);
    median_ce(v[48], v[49]); median_ce(v[50], v[51]); median_ce(v[52], v[53]);
    median_ce(v[54], v[55]); median_ce(v[56], v[57]); median_ce(v[58], v[59]);
    median_ce(v[60], v[61]); median_ce(v[62], v[63]); median_ce(v[0], v[2]);
    median_ce(v[1], v[3]); median_ce(v[4], v[6]); median_ce(v[5], v[7]);
    median_ce(v[8], v[10]); median_ce(v[9], v[11]); median_ce(v[12], v[14]);
    median_ce(v[13], v[15]); median_ce(v[16], v[18]); median_ce(v[17], v[19]);
    median_ce(v[20], v[22]); median_ce(v[21], v[23]); median_ce(v[24], v[26]);
    median_ce(v[25], v[27]); median_ce(v[28], v[30]); median_ce(v[29], v[31]);
    median_ce(v[32], v[34]); median_ce(v[33], v[35]); median_ce(v[36], v[38]);
    median_ce(v[37], v[39]); median_ce(v[40], v[42]); median_ce(v[41], v[43]);
    median_ce(v[44], v[46]); median_ce(v[45], v[47]); median_ce(v[48], v[50]);
    median_ce(v[49], v[51]); median_ce(v[52], v[54]); median_ce(v[53], v[55]);
    median_ce(v[56], v[58]); median_ce(v[57], v[59]); median_ce(v[60], v[62]);
    median_ce(v[61], v[63]); median_ce(v[1], v[2]); median_ce(v[5], v[6]);
    median_ce(v[9], v[10]); median_ce(v[13], v[14]); median_ce(v[17], v[18]);
    median_ce(v[21], v[22]); median_ce(v[25], v[26]); median_ce(v[29], v[30]);
    median_ce(v[33], v[34]); median_ce(v[37], v[38]); median_ce(v[41], v[42]);
    median_ce(v[45], v[46]); median_ce(v[49], v[50]); median_ce(v[53], v[54]);
    median_ce(v[57], v[58]); median_ce(v[61], v[62]); median_ce(v[0], v[4]);
    median_ce(v[1], v[5]); median_ce(v[2], v[6]); median_ce(v[3], v[7]);
    median_ce(v[8], v[12]); median_ce(v[9], v[13]); median_ce(v[10], v[14]);
    median_ce(v[11], v[15]); median_ce(v[16], v[20]); median_ce(v[17], v[21]);
    median_ce(v[18], v[22]); median_ce(v[19], v[23]); median_ce(v[24], v[28]);
    median_ce(v[25], v[29]); median_ce(v[26], v[30]); median_ce(v[27], v[31]);
    median_ce(v[32], v[36]); median_ce(v[33], v[37]); median_ce(v[34], v[38]);
    median_ce(v[35], v[39]); median_ce(v[40], v[44]); median_ce(v[41], v[45]);
    median_ce(v[42], v[46]); median_ce(v[43], v[47]); median_ce(v[48], v[52]);
    median_ce(v[49], v[53]); median_ce(v[50], v[54]); median_ce(v[51], v[55]);
    median_ce(v[56], v[60]); median_ce(v[57], v[61]); median_ce(v[58], v[62]);
    median_ce(v[59], v[63]); median_ce(v[2], v[4]); median_ce(v[3], v[5]);
    median_ce(v[10], v[12]); median_ce(v[11], v[13]); median_ce(v[18], v[20]);
    median_ce(v[19], v[21]); median_ce(v[26], v[28]); median_ce(v[27], v[29]);
    median_ce(v[34], v[36]); median_ce(v[35], v[37]); median_ce(v[42], v[44]);
    median_ce(v[43], v[45]); median_ce(v[50], v[52]); median_ce(v[51], v[53]);
    median_ce(v[58], v[60]); median_ce(v[59], v[61]); median_ce(v[1], v[2]);
    median_ce(v[3], v[4]); median_ce(v[5], v[6]); median_ce(v[9], v[10]);
    median_ce(v[11], v[12]); median_ce(v[13], v[14]); median_ce(v[17], v[18]);
    median_ce(v[19], v[20]); median_ce(v[21], v[22]); median_ce(v[25], v[26]);
    median_ce(v[27], v[28]); median_ce(v[29], v[30]); median_ce(v[33], v[34]);
    median_ce(v[35], v[36]); median_ce(v[37], v[38]); median_ce(v[41], v[42]);
    median_ce(v[43], v[44]); median_ce(v[45], v[46]); median_ce(v[49], v[50]);
    median_ce(v[51], v[52]); median_ce(v[53], v[54]); median_ce(v[57], v[58]);
    median_ce(v[59], v[60]); median_ce(v[61], v[62]); median_ce(v[0], v[8]);
    median_ce(v[1], v[9]); median_ce(v[2], v[10]); median_ce(v[3], v[11]);
    median_ce(v[4], v[12]); median_ce(v[5], v[13]); median_ce(v[6], v[14]);
    median_ce(v[7], v[15]); median_ce(v[16], v[24]); median_ce(v[17], v[25]);
    median_ce(v[18], v[26]); median_ce(v[19], v[27]); median_ce(v[20], v[28]);
    median_ce(v[21], v[29]); median_ce(v[22], v[30]); median_ce(v[23], v[31]);
    median_ce(v[32], v[40]); median_ce(v[33], v[41]); median_ce(v[34], v[42]);
    median_ce(v[35], v[43]); median_ce(v[36], v[44]); median_ce(v[37], v[45]);
    median_ce(v[38], v[46]); median_ce(v[39], v[47]); median_ce(v[48], v[56]);
    median_ce(v[49], v[57]); median_ce(v[50], v[58]); median_ce(v[51], v[59]);
    median_ce(v[52], v[60]); median_ce(v[53], v[61]); median_ce(v[54], v[62]);
    median_ce(v[55], v[63]); median_ce(v[4], v[8]); median_ce(v[5], v[9]);
    median_ce(v[6], v[10]); median_ce(v[7], v[11]); median_ce(v[20], v[24]);
    median_ce(v[21], v[25]); median_ce(v[22], v[26]); median_ce(v[23], v[27]);
    median_ce(v[36], v[40]); median_ce(v[37], v[41]); median_ce(v[38], v[42]);
    median_ce(v[39], v[43]); median_ce(v[52], v[56]); median_ce(v[53], v[57]);
    median_ce(v[54], v[58]); median_ce(v[55], v[59]); median_ce(v[2], v[4]);
    median_ce(v[3], v[5]); median_ce(v[6], v[8]); median_ce(v[7], v[9]);
    median_ce(v[10], v[12]); median_ce(v[11], v[13]); median_ce(v[18], v[20]);
    median_ce(v[19], v[21]); median_ce(v[22], v[24]); median_ce(v[23], v[25]);
    median_ce(v[26], v[28]); median_ce(v[27], v[29]); median_ce(v[34], v[36]);
    median_ce(v[35], v[37]); median_ce(v[38], v[40]); median_ce(v[39], v[41]);
    median_ce(v[42], v[44]); median_ce(v[43], v[45]); median_ce(v[50], v[52]);
    median_ce(v[51], v[53]); median_ce(v[54], v[56]); median_ce(v[55], v[57]);
    median_ce(v[58], v[60]); median_ce(v[59], v[61]); median_ce(v[1], v[2]);
    median_ce(v[3], v[4]); median_ce(v[5], v[6]); median_ce(v[7], v[8]);
    median_ce(v[9], v[10]); median_ce(v[11], v[12]); median_ce(v[13], v[14]);
    median_ce(v[17], v[18]); median_ce(v[19], v[20]); median_ce(v[21], v[22]);
    median_ce(v[23], v[24]); median_ce(v[25], v[26]); median_ce(v[27], v[28]);
    median_ce(v[29], v[30]); median_ce(v[33], v[34]); median_ce(v[35], v[36]);
    median_ce(v[37], v[38]); median_ce(v[39], v[40]); median_ce(v[41], v[42]);
    median_ce(v[43], v[44]); median_ce(v[45], v[46]); median_ce(v[49], v[50]);
    median_ce(v[51], v[52]); median_ce(v[53], v[54]); median_ce(v[55], v[56]);
    median_ce(v[57], v[58]); median_ce(v[59], v[60]); median_ce(v[61], v[62]);
    median_ce(v[0], v[16]); median_ce(v[1], v[17]); median_ce(v[2], v[18]);
    median_ce(v[3], v[19]); median_ce(v[4], v[20]); median_ce(v[5], v[21]);
    median_ce(v[6], v[22]); median_ce(v[7], v[23]); median_ce(v[8], v[24]);
    median_ce(v[9], v[25]); median_ce(v[10], v[26]); median_ce(v[11], v[27]);
    median_ce(v[12], v[28]); median_ce(v[13], v[29]); median_ce(v[14], v[30]);
    median_ce(v[15], v[31]); median_ce(v[32], v[48]); median_ce(v[33], v[49]);
    median_ce(v[34], v[50]); median_ce(v[35], v[51]); median_ce(v[36], v[52]);
    median_ce(v[37], v[53]); median_ce(v[38], v[54]); median_ce(v[39], v[55]);
    median_ce(v[40], v[56]); median_ce(v[41], v[57]); median_ce(v[42], v[58]);
    median_ce(v[43], v[59]); median_ce(v[44], v[60]); median_ce(v[45], v[61]);
    median_ce(v[46], v[62]); median_ce(v[47], v[63]); median_ce(v[8], v[16]);
    median_ce(v[9], v[17]); median_ce(v[10], v[18]); median_ce(v[11], v[19]);
    median_ce(v[12], v[20]); median_ce(v[13], v[21]); median_ce(v[14], v[22]);
    median_ce(v[15], v[23]); median_ce(v[40], v[48]); median_ce(v[41], v[49]);
    median_ce(v[42], v[50]); median_ce(v[43], v[51]); median_ce(v[44], v[52]);
    median_ce(v[45], v[53]); median_ce(v[46], v[54]); median_ce(v[47], v[55]);
    median_ce(v[4], v[8]); median_ce(v[5], v[9]); median_ce(v[6], v[10]);
    median_ce(v[7], v[11]); median_ce(v[12], v[16]); median_ce(v[13], v[17]);
    median_ce(v[14], v[18]); median_ce(v[15], v[19]); median_ce(v[20], v[24]);
    median_ce(v[21], v[25]); median_ce(v[22], v[26]); median_ce(v[23], v[27]);
    median_ce(v[36], v[40]); median_ce(v[37], v[41]); median_ce(v[38], v[42]);
    median_ce(v[39], v[43]); median_ce(v[44], v[48]); median_ce(v[45], v[49]);
    median_ce(v[46], v[50]); median_ce(v[47], v[51]); median_ce(v[52], v[56]);
    median_ce(v[53], v[57]); median_ce(v[54], v[58]); median_ce(v[55], v[59]);
    median_ce(v[2], v[4]); median_ce(v[3], v[5]); median_ce(v[6], v[8]);
    median_ce(v[7], v[9]); median_ce(v[10], v[12]); median_ce(v[11], v[13]);
    median_ce(v[14], v[16]); median_ce(v[15], v[17]); median_ce(v[18], v[20]);
    median_ce(v[19], v[21]); median_ce(v[22], v[24]); median_ce(v[23], v[25]);
    median_ce(v[26], v[28]); median_ce(v[27], v[29]); median_ce(v[34], v[36]);
    median_ce(v[35], v[37]); median_ce(v[38], v[40]); median_ce(v[39], v[41]);
    median_ce(v[42], v[44]); median_ce(v[43], v[45]); median_ce(v[46], v[48]);
    median_ce(v[47], v[49]); median_ce(v[50], v[52]); median_ce(v[51], v[53]);
    median_ce(v[54], v[56]); median_ce(v[55], v[57]); median_ce(v[58], v[60]);
    median_ce(v[59], v[61]); median_ce(v[1], v[2]); median_ce(v[3], v[4]);
    median_ce(v[5], v[6]); median_ce(v[7], v[8]); median_ce(v[9], v[10]);
    median_ce(v[11], v[12]); median_ce(v[13], v[14]); median_ce(v[15], v[16]);
    median_ce(v[17], v[18]); median_ce(v[19], v[20]); median_ce(v[21], v[22]);
    median_ce(v[23], v[24]); median_ce(v[25], v[26]); median_ce(v[27], v[28]);
    median_ce(v[29], v[30]); median_ce(v[33], v[34]); median_ce(v[35], v[36]);
    median_ce(v[37], v[38]); median_ce(v[39], v[40]); median_ce(v[41], v[42]);
    median_ce(v[43], v[44]); median_ce(v[45], v[46]); median_ce(v[47], v[48]);
    median_ce(v[49], v[50]); median_ce(v[51], v[52]); median_ce(v[53], v[54]);
    median_ce(v[55], v[56]); median_ce(v[57], v[58]); median_ce(v[59], v[60]);
    median_ce(v[61], v[62]); median_hi(v[0], v[32]); median_hi(v[1], v[33]);
    median_hi(v[2], v[34]); median_hi(v[3], v[35]); median_hi(v[4], v[36]);
    median_hi(v[5], v[37]); median_hi(v[6], v[38]); median_hi(v[7], v[39]);
    median_hi(v[8], v[40]); median_hi(v[9], v[41]); median_hi(v[10], v[42]);
    median_hi(v[11], v[43]); median_hi(v[12], v[44]); median_hi(v[13], v[45]);
    median_hi(v[14], v[46]); median_hi(v[15], v[47]); median_lo(v[16], v[48]);
    median_lo(v[17], v[49]); median_lo(v[18], v[50]); median_lo(v[19], v[51]);
    median_lo(v[20], v[52]); median_lo(v[21], v[53]); median_lo(v[22], v[54]);
    median_lo(v[23], v[55]); median_lo(v[24], v[56]); median_lo(v[25], v[57]);
    median_lo(v[26], v[58]); median_lo(v[27], v[59]); median_lo(v[28], v[60]);
    median_lo(v[29], v[61]); median_lo(v[30], v[62]); median_lo(v[31], v[63]);
    median_hi(v[16], v[32]); median_hi(v[17], v[33]); median_hi(v[18], v[34]);
    median_hi(v[19], v[35]); median_hi(v[20], v[36]); median_hi(v[21], v[37]);
    median_hi(v[22], v[38]); median_hi(v[23], v[39]); median_lo(v[24], v[40]);
    median_lo(v[25], v[41]); median_lo(v[26], v[42]); median_lo(v[27], v[43]);
    median_lo(v[28], v[44]); median_lo(v[29], v[45]); median_lo(v[30], v[46]);
    median_lo(v[31], v[47]); median_hi(v[24], v[32]); median_hi(v[25], v[33]);
    median_hi(v[26], v[34]); median_hi(v[27], v[35]); median_lo(v[28], v[36]);
    median_lo(v[29], v[37]); median_lo(v[30], v[38]); median_lo(v[31], v[39]);
    median_hi(v[28], v[32]); median_hi(v[29], v[33]); median_lo(v[30], v[34]);
    median_lo(v[31], v[35]); median_hi(v[30], v[32]); median_lo(v[31], v[33]);
    median_lo(v[31], v[32]);
  }
};
