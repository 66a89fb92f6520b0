// The flash forward's f32 routes of csrc/flash_fwd.cu (vd_flash_fwd_f32, the
// SIMT kernel; vd_flash_fwd_tf32x3, the 128-row tf32x3 kernel and its K/V
// splits), built into a library of their own beside the bf16 one, so that
// the two nvcc runs go in parallel.
#define VD_FLASH_FWD_F32 1
#include "flash_fwd.cu"
