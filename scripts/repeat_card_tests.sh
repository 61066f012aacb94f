#!/usr/bin/env bash
# Run the card test files N times, each run one pytest process in the
# suite's order (tests/test_torch_kernels_gpu.py, then
# tests/test_torch_graph_gpu.py), and print each run's exit code and
# summary, the tests that failed, and how many runs failed.  Needs a CUDA
# card; run from the root of a checkout:
#
#     bash scripts/repeat_card_tests.sh [N]      # N defaults to 10
set -u
n=${1:-10}
failed=0
for i in $(seq 1 "$n"); do
  out=$(python -m pytest -q -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py tests/test_torch_graph_gpu.py 2>&1)
  rc=$?
  echo "run $i rc=$rc: $(echo "$out" | tail -n 1)"
  echo "$out" | grep '^FAILED' || true
  [ "$rc" -eq 0 ] || failed=$((failed + 1))
done
echo "failed runs: $failed of $n"
