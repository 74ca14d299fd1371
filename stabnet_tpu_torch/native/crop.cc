// Native post-processing for the PyTorch port of StabNet.
//
// max_clear_rect: largest all-clear rectangle in a black-pixel accumulation
// map (reference algorithm: deploy_bundle.py:344-365, an O(H^2 W^2) prefix-sum
// search; here the exact O(H*W) largest-rectangle-in-histogram algorithm, the
// same scan, tie-breaks included, as ops/crop.max_clear_rect_plain).
//
// Built as a plain shared library with g++ and loaded through ctypes
// (native/native_ops.py).

#include <cstdint>
#include <vector>

extern "C" {

// black: row-major H*W int64 counts (>0 = excluded).
// out: int64[5] = {top, left, bottom, right, found}.
void max_clear_rect(const int64_t* black, int64_t H, int64_t W, int64_t* out) {
  std::vector<int64_t> heights(W, 0);
  std::vector<int64_t> stack_col(W + 1);
  std::vector<int64_t> stack_h(W + 1);

  int64_t best_area = 0;
  int64_t bt = 0, bl = 0, bb = 0, br = 0;
  bool found = false;

  for (int64_t r = 0; r < H; ++r) {
    const int64_t* row = black + r * W;
    for (int64_t c = 0; c < W; ++c) {
      heights[c] = row[c] > 0 ? 0 : heights[c] + 1;
    }
    int64_t top = 0;  // stack size
    for (int64_t c = 0; c <= W; ++c) {
      int64_t h = c < W ? heights[c] : 0;
      int64_t start = c;
      while (top > 0 && stack_h[top - 1] >= h) {
        --top;
        int64_t s = stack_col[top];
        int64_t sh = stack_h[top];
        int64_t area = sh * (c - s);
        if (area > best_area) {
          best_area = area;
          bt = r - sh + 1;
          bl = s;
          bb = r;
          br = c - 1;
          found = true;
        }
        start = s;
      }
      if (h > 0) {
        stack_col[top] = start;
        stack_h[top] = h;
        ++top;
      }
    }
  }
  out[0] = bt;
  out[1] = bl;
  out[2] = bb;
  out[3] = br;
  out[4] = found ? 1 : 0;
}

}  // extern "C"
