// S2 on Hopper: the probes of tools/spike_dma.py (w1, its check kernel, w1b, w2, w3, w4, w5: the DMA legality and cost probes).
//
// Replaces the pl.pallas_call sites of tools/spike_dma.py; each probe's step code and
// what it replaces is in spike_common.cuh, its plain version and its
// inputs in csc_tpu_torch/spikes/dma.py.  One spike_kernel instance per
// probe, each launched in layout a (one stream per block) or b (128
// streams per block).
#include <cuda_runtime.h>

#include "spike_common.cuh"

SPK_LAUNCH(dma)
