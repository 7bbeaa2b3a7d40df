// S3 on Hopper: the probes of tools/spike_gather.py (make_run: REPS reads or writes of a [B, 256] table a step).
//
// Replaces the pl.pallas_call sites of tools/spike_gather.py; each probe's step code and
// what it replaces is in spike_common.cuh, its plain version and its
// inputs in csc_tpu_torch/spikes/gather.py.  One spike_kernel instance per
// probe, each launched in layout a (one stream per block) or b (128
// streams per block).
#include <cuda_runtime.h>

#include "spike_common.cuh"

SPK_LAUNCH(gather)
