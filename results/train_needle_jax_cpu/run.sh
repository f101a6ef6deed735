#!/bin/bash
# The JAX reference of chip_smoke.py's needle training check: the port's
# initial weights (seed 0, written by make_init.py) trained 20 steps at
# the full needle shape (B = 32, S = 1024) by the unmodified JAX example on
# the CPU. Writes jax_cpu.log beside this script; chip_smoke.py reads the
# digest and the losses at steps 0 and 19 from it. XLA's warnings are
# left out of the log.
#   bash results/train_needle_jax_cpu/run.sh
set -euo pipefail
here=$(cd "$(dirname "$0")" && pwd)
root=$(cd "$here/../.." && pwd)
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
cd "$root"
{
  echo "+ python results/train_needle_jax_cpu/make_init.py --seed 0 --seq 1024 --out <tmp>/init.npz"
  python results/train_needle_jax_cpu/make_init.py --seed 0 --seq 1024 \
    --out "$tmp/init.npz"
  echo "+ JAX_PLATFORMS=cpu python examples/train_needle.py --init <tmp>/init.npz --steps 20 --batch 32 --seq 1024 --seed 0 --out <tmp>/jax.npz"
  JAX_PLATFORMS=cpu python examples/train_needle.py --init "$tmp/init.npz" \
    --steps 20 --batch 32 --seq 1024 --seed 0 --out "$tmp/jax.npz"
  python -c "import sys, jax, torch; print('python', sys.version.split()[0], 'jax', jax.__version__, 'torch', torch.__version__)"
} 2>&1 | grep -a -E '^(\+ |init digest |step |saved |python )' \
  | sed "s#$tmp#<tmp>#g" | tee "$here/jax_cpu.log"
