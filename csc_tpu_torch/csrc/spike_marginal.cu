// S4 on Hopper: the probes of tools/spike_marginal.py (_pc (m1, m1b, m2, m3, m6, m6b, m7, m8, m9), m4, m5, m5b).
//
// Replaces the pl.pallas_call sites of tools/spike_marginal.py; each probe's step code and
// what it replaces is in spike_common.cuh, its plain version and its
// inputs in csc_tpu_torch/spikes/marginal.py.  One spike_kernel instance per
// probe, each launched in layout a (one stream per block) or b (128
// streams per block).
#include <cuda_runtime.h>

#include "spike_common.cuh"

SPK_LAUNCH(marginal)
