#!/usr/bin/env python3
"""
Device time of the port's dsk kernels (``csrc/dsk.cu``) on one NVIDIA GPU,
cold and warm, on the cases of ``chip_smoke.py``'s ``[dsk]`` phase.

    python3 scripts/time_dsk.py [--tree DIR] [--sweep] [--sizes N ...]

Builds this checkout's ``planetmapper_tpu_torch/csrc/dsk.cu`` with its
wrapper's nvcc flags and, with ``--tree``, another checkout's ``dsk.cu``
with the same flags (its C interface, ``dsk_pairs_launch`` and
``dsk_atan2_launch``, is the same), all builds in parallel. On the JAX dsk
tests' three cases (``testing/dsk_cases.py``; ds mul, div, hypot and
atan2_ds pairs, float32 atan2) at each size (default 8192 and 2048^2
values) it times every op of every build on the same buffers, and one
PyTorch call beside them as a yardstick (the float64 op over the same
bytes for a pair op, ``torch.atan2`` in float32 for atan2), with the timers
of ``planetmapper_tpu_torch/testing/timing.py`` in two turns (the other
checkout, this one, this one, the other checkout):

- cold: one launch right after a read of a 128 MB buffer (larger than the
  50 MB L2), the events around the launch alone, median of 50;
- warm: 200 launches back to back between two events, per launch.

``--sweep`` adds the layouts the kernel's were chosen from: this
checkout's source built with ``-DDSK_GROUPS=U`` (U float4 groups of 4
values a thread, V U in {4, 8, 16}) and ``-DDSK_PERSISTENT=0|1`` (one block
per 256 V U values, or the SMs times the resident blocks with a
grid-stride loop). Every build's output is first held against this
checkout's (word for word; atan2_ds of a checkout whose kernel runs the
double-single chain within ``dsk_cases.ATAN2_DS_VS_PLAIN``), and each
build's ptxas registers are printed. Results are one JSON line per op and
size, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from planetmapper_tpu_torch.ops import cuda_build, dsk  # noqa: E402
from planetmapper_tpu_torch.ops import dsk_kernel as dskk  # noqa: E402
from planetmapper_tpu_torch.testing import (bounds, dsk_cases,  # noqa: E402
                                            timing)

#: The sweep: (U, persistent) of each variant
SWEEP = [(u, p) for p in (0, 1) for u in (1, 2, 4)]
YARDSTICKS = {'mul': torch.mul, 'div': torch.div, 'hypot': torch.hypot,
              'atan2_ds': torch.atan2, 'atan2': torch.atan2}


def libraries(tree: Path | None, sweep: bool) -> dict:
    """name -> CudaLibrary: this checkout's, the other tree's, the sweep's."""
    flags = dskk.LIBRARY.flags[len(cuda_build.NVCC_FLAGS):]
    libs = {'this': dskk.LIBRARY}
    if tree is not None:
        source = tree / 'planetmapper_tpu_torch' / 'csrc' / 'dsk.cu'
        libs['tree'] = cuda_build.CudaLibrary('dsk_tree', source,
                                              dskk._configure, flags)
    if sweep:
        for u, persistent in SWEEP:
            libs[f'V*U={4 * u} {"persistent" if persistent else "chunks"}'] = \
                cuda_build.CudaLibrary(
                    'dsk_sweep', 'dsk.cu', dskk._configure,
                    (*flags, f'-DDSK_GROUPS={u}',
                     f'-DDSK_PERSISTENT={persistent}'))
    return libs


def registers(lib) -> str:
    """'entry: N registers' for each kernel of a build's ptxas report."""
    out, entry = [], ''
    for line in lib.ptxas_log().splitlines():
        if 'Compiling entry function' in line:
            found = re.search(r'(dsk_pairs|dsk_atan2)(?:ILi(\d)E)?', line)
            entry = (f'{found[1]}<{dskk.OPS[int(found[2])]}>' if found[2]
                     else found[1]) if found else line
        elif 'registers' in line:
            out.append(f'{entry}: {line.split("Used", 1)[-1].strip()}')
    return '; '.join(out)


def launcher(lib, op: str, ins, outs):
    """One launch of ``op`` from ``lib`` on the current stream."""
    handle = lib.load()
    ptrs = [t.data_ptr() for t in (*ins, *outs)]
    n = outs[0].numel()

    def fn():
        stream = torch.cuda.current_stream().cuda_stream
        if op == 'atan2':
            rc = handle.dsk_atan2_launch(*ptrs, n, stream)
        else:
            rc = handle.dsk_pairs_launch(dskk.OPS.index(op), *ptrs, n, stream)
        cuda_build.check_launch(rc, f'{lib.name} {op}')
    return fn


def inputs(op: str, n: int, device):
    """The op's case at n values on the card: (inputs, yardstick inputs)."""
    if op == 'atan2':
        y, x = (torch.from_numpy(v).to(device)
                for v in dsk_cases.atan2_inputs(n))
        return (y, x), (y, x)
    a, b = (dsk.split_f64(torch.from_numpy(v).to(device))
            for v in dsk_cases.pair_inputs(op, n))
    return (*a, *b), (a[0].double() + a[1].double(),
                      b[0].double() + b[1].double())


def check(op: str, name: str, got, ref) -> None:
    """Every build's words equal this checkout's; a double-single atan2_ds
    (another checkout's) within the bar."""
    same = [(g.view(torch.int32) == r.view(torch.int32))
            | (torch.isnan(g) & torch.isnan(r)) for g, r in zip(got, ref)]
    if all(bool(t.all()) for t in same):
        return
    if op == 'atan2_ds' and name == 'tree':
        diff = (got[0].double() + got[1].double()
                - ref[0].double() - ref[1].double()).abs()
        if float(diff.nan_to_num(0.0).max()) <= dsk_cases.ATAN2_DS_VS_PLAIN:
            return
    raise SystemExit(f'FAIL: {name} {op} differs from this checkout')


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tree', type=Path, default=None,
                        help='another checkout whose dsk.cu to time')
    parser.add_argument('--sweep', action='store_true',
                        help="time the layouts the kernel's were chosen from")
    parser.add_argument('--sizes', type=int, nargs='+',
                        default=[dsk_cases.N_TEST, timing.SIZE ** 2])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA device')
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device('cuda')
    libs = libraries(args.tree.resolve() if args.tree else None, args.sweep)
    cuda_build.build_all(list(libs.values()))
    for name, lib in libs.items():
        print(f'{card} | {name}: nvcc {lib.build_seconds:.1f} s; '
              f'{registers(lib)}', flush=True)
    flush = timing.l2_flush(device)
    for n in args.sizes:
        for op in (*dskk.OPS, 'atan2'):
            ins, yard_ins = inputs(op, n, device)
            fns, outs = {}, {}
            # the other checkout first: its turns bracket this one's
            for name in sorted(libs, key=lambda k: k != 'tree'):
                outs[name] = [torch.empty_like(ins[0])
                              for _ in range(1 if op == 'atan2' else 2)]
                fns[name] = launcher(libs[name], op, ins, outs[name])
                fns[name]()
            torch.cuda.synchronize()
            for name in libs:
                check(op, name, outs[name], outs['this'])
            fns['yardstick'] = lambda f=YARDSTICKS[op], a=yard_ins: f(*a)
            cold = timing.in_turns({k: (f, 50) for k, f in fns.items()},
                                   lambda f, r: timing.cold_time_ms(f, r,
                                                                    flush))
            warm = timing.in_turns({k: (f, 200) for k, f in fns.items()},
                                   timing.cuda_time_ms)
            branches = (bounds.atan2_branches(ins[0], ins[2])
                        if op == 'atan2_ds' else
                        bounds.atan2_branches(*ins) if op == 'atan2' else {})
            bound = bounds.dsk_call_bound(op, n, **branches)
            print(f'{card} | dsk {op} {n} values, us per call (two turns '
                  'each): ' + json.dumps(dict(
                      bound_us=bound['ms'] * 1e3, bound_by=bound['bound_by'],
                      cold={k: [t * 1e3 for t in v] for k, v in cold.items()},
                      warm={k: [t * 1e3 for t in v] for k, v in warm.items()},
                  )), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
