// K7 on K1's Hopper loop at head dim 160 (probe_attention_sm90.cuh); one
// translation unit a head dim, so that the instantiations build in parallel.

#include "probe_attention_sm90.cuh"

int cpd_probe::sm90_w160(const Args& a, cudaStream_t s) { return probe_sm90<160>(a, s); }
