// The tracer's phase marker (uemda_tpu_torch/utils/trace.py): one thread
// that writes the device's %globaltimer (ns) and a phase id into the ring's
// row of the current replay, (rows, slots, 2) int64 [ns, id]. The row is
// the replay counter modulo rows; the marker of a step's last boundary
// (id 0) advances the counter, so each replay of a captured graph writes a
// row of its own and the host reads the ring only when it chooses. A
// marker runs after the kernels enqueued before it on its stream, so the
// difference of two markers is the device time of the work between them.

#include "common.cuh"

__global__ void uemda_phase_mark(long long* ring, long long* counter,
                                 int slot, int id, int rows, int slots) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long row = counter[0] % rows;
  long long* e = ring + (row * slots + slot) * 2;
  e[0] = static_cast<long long>(now);
  e[1] = id;
  if (id == 0) counter[0] += 1;
}

extern "C" int uemda_phase_mark_launch(void* ring, void* counter, int slot,
                                       int id, int rows, int slots,
                                       void* stream) {
  uemda_phase_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(counter), slot,
      id, rows, slots);
  return static_cast<int>(cudaGetLastError());
}
