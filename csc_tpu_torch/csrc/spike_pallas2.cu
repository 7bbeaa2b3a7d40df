// S7 on Hopper: the probes of tools/spike_pallas2.py (s1-s7).
//
// Replaces the pl.pallas_call sites of tools/spike_pallas2.py; each probe's step code and
// what it replaces is in spike_common.cuh, its plain version and its
// inputs in csc_tpu_torch/spikes/pallas2.py.  One spike_kernel instance per
// probe, each launched in layout a (one stream per block) or b (128
// streams per block).
#include <cuda_runtime.h>

#include "spike_common.cuh"

SPK_LAUNCH(pallas2)
