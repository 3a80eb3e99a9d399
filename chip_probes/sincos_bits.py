#!/usr/bin/env python3
"""Whether ``sincosf`` gives the bits of ``cosf`` and ``sinf`` on the card.

``csrc/walk_kernel.cu::mis_nee`` takes ``cosf`` and ``sinf`` of one angle
(the Box-Muller sample's ``TWO_PI * u8``, in [0, 2 pi)). One ``sincosf``
may take their place in a build only where it changes no bit. This probe
builds, with the walk kernel's ``nvcc`` flags, two kernels over every
float in [0, 2 pi] (each bit pattern from +0 up to the float nearest
2 pi, which a product ``TWO_PI * u8`` may round to): the pair as
``mis_nee`` takes it, and by ``sincosf``; it counts the floats where
either result differs bit for bit, and prints each
kernel's SASS size and ``MUFU`` opcodes (``cuobjdump``): equal code means
``nvcc`` already made one of the other. Writes
``chiprun_out/sincos_bits.json``.

    python3 chip_probes/sincos_bits.py
"""

import ctypes
import json
import math
import os
import re
import struct
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402

WORK = ROOT / "_archive" / "sincos_bits"
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// every float x in [0, 2 pi] by its bits, 0 .. hi: the pair as mis_nee
// takes it, and by sincosf
__global__ void compare(uint32_t hi, unsigned long long* bad) {
  unsigned long long b = 0;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i <= hi;
       i += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((uint32_t)i);
    const float c = cosf(x), s = sinf(x);
    float s2, c2;
    sincosf(x, &s2, &c2);
    b += (__float_as_uint(c) != __float_as_uint(c2)) ||
         (__float_as_uint(s) != __float_as_uint(s2));
  }
  atomicAdd(bad, b);
}
__global__ void separate(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float c = cosf(x[i]), s = sinf(x[i]);
    out[2 * i] = c;
    out[2 * i + 1] = s;
  }
}
__global__ void fused(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float c, s;
    sincosf(x[i], &s, &c);
    out[2 * i] = c;
    out[2 * i + 1] = s;
  }
}
extern "C" int count_mismatches(uint32_t hi, unsigned long long* out) {
  unsigned long long* d;
  if (cudaMalloc(&d, sizeof *d) != cudaSuccess) return -1;
  cudaMemset(d, 0, sizeof *d);
  compare<<<2048, 256>>>(hi, d);
  cudaMemcpy(out, d, sizeof *d, cudaMemcpyDeviceToHost);
  cudaFree(d);
  return (int)cudaGetLastError();
}
"""


def sass_of(so):
    """``{kernel: (instructions, {MUFU opcode: count})}``."""
    cuobjdump = os.path.join(os.path.dirname(wk._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = [0, {}]
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            out[fn][0] += 1
            m = re.search(r"\b(MUFU\.\w+)", line)
            if m:
                out[fn][1][m.group(1)] = out[fn][1].get(m.group(1), 0) + 1
    return {k: v for k, v in out.items()
            if "separate" in k or "fused" in k}


def main():
    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / "sincos_bits.cu"
    src.write_text(SOURCE)
    so = WORK / "sincos_bits.so"
    subprocess.run([wk._nvcc(), *wk.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    hi = struct.unpack("<I", struct.pack("<f", 2.0 * math.pi))[0]
    bad = ctypes.c_ulonglong(0)
    assert lib.count_mismatches(ctypes.c_uint32(hi), ctypes.byref(bad)) == 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    record = dict(floats=hi + 1, mismatches=int(bad.value), sass=sass_of(so),
                  card=card)
    print(json.dumps(record), flush=True)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "sincos_bits.json").write_text(json.dumps(record))


if __name__ == "__main__":
    main()
