#!/usr/bin/env bash
# Time two trees' kernels in turns on one card, and digest both.
#
#     bash tools/parent_turns.sh PARENT_DIR [OUT_DIR]
#
# PARENT_DIR is another checkout of the repository (for example the
# parent commit unpacked with `git archive <commit> | tar -x -C DIR` into a
# directory that .gitignore lists). Runs `python3 chip_smoke.py` in the
# parent, this tree, this tree and the parent, in that order, each tree
# building its own kernels into its own build/, so that a difference
# between the trees is read against the spread of the same tree's two
# runs on the same card. Then `tools/port_digest.py` on each tree's
# package and a diff of the two digests (lines that differ are printed;
# the tc lines may, the swc and swc_stream lines must not). Every log
# goes to OUT_DIR (default build/turns/). Needs one CUDA card.
set -euo pipefail
parent=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
out=${2:-$here/build/turns}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
turn=0
for tree in parent change change parent; do
  turn=$((turn + 1))
  dir=$here
  [ "$tree" = parent ] && dir=$parent
  log="$out/turn${turn}_$tree.log"
  start=$(date +%s)
  (cd "$dir" && python3 chip_smoke.py) > "$log" 2>&1
  echo "turn $turn ($tree): rc 0, $(( $(date +%s) - start )) s, $log"
done
PYTHONPATH="$parent/src" python3 "$here/tools/port_digest.py" \
  > "$out/digest_parent.txt"
PYTHONPATH="$here/src" python3 "$here/tools/port_digest.py" \
  > "$out/digest_change.txt"
echo "digest lines: $(wc -l < "$out/digest_change.txt"); differing:"
diff "$out/digest_parent.txt" "$out/digest_change.txt" | grep '^>' \
  | cut -d: -f1 || true
