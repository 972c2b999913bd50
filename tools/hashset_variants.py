"""Time variants of the hash set's kernel (``stateright_tpu_torch/csrc/
hashset.cu``) on the card.

Each variant is the kernel's source with a textual change, built by
``nvcc`` with the port's flags into ``build/kernels/variants/``. Every
variant's insert and undo are timed (device time alone, as
``chip_smoke.py`` times the kernel) on two batches: the seeded rm=9-wide
batch of ``chip_smoke.py``'s ``hashset_kernel`` phase, and the batch of 2pc
rm=9's widest level under ``dedup="hash"`` (``chip_smoke.level_batch``).
Variants that drop work (``no_min``, ``no_vals``, ``no_window``) are not
correct; they price that work. Prints one JSON line a batch.

Run on the card from the repository root::

    python3 tools/hashset_variants.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from stateright_tpu_torch.models.two_phase_commit import PackedTwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops import _cuda, hashset  # noqa: E402

#: name -> the (text in the kernel's source, its replacement) pairs.
VARIANTS = {
    "kernel": [],
    "threads_128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "threads_512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "threads_1024": [("constexpr int kThreads = 256;", "constexpr int kThreads = 1024;")],
    "commit_one_entry_a_thread": [(
        "commit_kernel<<<grid_for(m)",
        "commit_kernel<<<static_cast<unsigned>((m + kThreads - 1) / kThreads)")],
    "undo_one_slot_a_thread": [
        ("const long long n = 2LL * filled[0];", "const long long n = filled[0];"),
        ("const unsigned long long s = static_cast<unsigned>(filled[2 + (e >> 1)]);\n"
         "    reinterpret_cast<ulonglong2*>(slots + s * kWords)[e & 1] =\n"
         "        make_ulonglong2(0ull, (e & 1) ? 0ull : kRest);",
         "const unsigned long long s = static_cast<unsigned>(filled[2 + e]);\n"
         "    reinterpret_cast<ulonglong2*>(slots + s * kWords)[0] = make_ulonglong2(0ull, kRest);\n"
         "    reinterpret_cast<ulonglong2*>(slots + s * kWords)[1] = make_ulonglong2(0ull, 0ull);"),
    ],
    "no_min": [("atomicMin(reinterpret_cast<long long*>(slots + s * kWords + kTicket),\n"
                "                    static_cast<long long>(ticket));", "")],
    "no_vals": [("w[kVal] = pack(vh[i], vl[i]);", "w[kVal] = i;")],
    "no_window": [("bool full = true;", "bool full = false;"),
                  ("for (long long p = before + 1; p < max_probes; ++p) {",
                   "for (long long p = max_probes; p < max_probes; ++p) {")],
}


def build() -> dict:
    """Every variant's library, built in parallel."""
    src = (_cuda.CSRC / "hashset.cu").read_text()
    out = _cuda.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, changes in VARIANTS.items():
        text = src
        for old, new in changes:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the kernel's source")
            text = text.replace(old, new)
        path = out / f"{name}.cu"
        path.write_text(text)
        so = out / f"lib{name}.so"
        procs.append((name, so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o", str(so), str(path)])))
    libs = {}
    for name, so, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"variant {name}: nvcc failed")
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in _cuda._SIGNATURES["hashset"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.stpu_error_string.argtypes = [ctypes.c_int]
        lib.stpu_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def measure(tag: str, libs: dict, t, lanes, rounds: int = 2) -> None:
    """Insert and undo ms of every variant, ``rounds`` times in turn."""
    drop = torch.zeros((), dtype=torch.bool, device="cuda")
    ms = {}
    for _ in range(rounds):
        for name, lib in libs.items():
            _cuda._loaded["hashset"] = lib
            copies = iter([cs._hash_copy(t) for _ in range(7)])
            insert_ms = cs.timed_ms(lambda: hashset.insert_(next(copies), *lanes), reps=5, queued=True)
            del copies
            done = iter([(c, *hashset.insert_(c, *lanes)) for c in (cs._hash_copy(t) for _ in range(3))])

            def undo_next():
                c, _, _, filled = next(done)
                hashset.undo_(c, filled, drop)

            undo_ms = cs.timed_ms(undo_next, reps=1, queued=True)
            del done
            _cuda._loaded.pop("hashset")
            ms.setdefault(name, []).append({"insert_ms": insert_ms, "undo_ms": undo_ms})
            torch.cuda.empty_cache()
    print(json.dumps({"batch": tag, "C": t.capacity, "m": lanes[0].shape[0],
                      "active": int(lanes[4].sum()), "variants": ms}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("hashset_variants: no CUDA device", file=sys.stderr)
        return 2
    os.chdir(Path(__file__).resolve().parents[1])
    cs.device_phase()
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(2026)
    base = hashset.make(cs.HASH_TABLE, "cuda")
    base_keys = torch.randint(1, 2**62, (cs.HASH_TABLE // 8,), dtype=torch.int64, device="cuda",
                              generator=gen)
    hashset.insert_(base, *cs._lanes_of(base_keys, gen))
    measure("seeded", libs, base, cs._batch_lanes(gen, 1 << 25, 16_395_948, 0.4, base_keys))
    del base, base_keys
    torch.cuda.empty_cache()
    cs.PROGRAM_USE = cs.ProgramUse()
    model = PackedTwoPhaseSys(cs.SOAK_RM)
    c = model.checker().spawn_xla(dedup="hash").join()
    t, lanes, _, _ = cs.level_batch(model, "hash", c)
    del c
    measure("rm9_widest_level", libs, t, lanes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
