#!/bin/sh
# Full-suite runner with per-file process isolation.
#
# Why: a single long-lived pytest process accumulates many large XLA
# CPU compiles; per-file processes localize a compiler crash to one shard
# and let the rest of the suite finish.
#
# Usage:  sh scripts/run_suite_sharded.sh [extra pytest args...]
# Exit 0 iff every shard passed.
set -u
cd "$(dirname "$0")/.."
fail=0
t0=$(date +%s)
for f in tests/test_*.py; do
    ts=$(date +%s)
    if python -m pytest "$f" -q "$@" > /tmp/shard.log 2>&1; then
        tail -1 /tmp/shard.log | sed "s#^#[$f $(( $(date +%s) - ts ))s] #"
    else
        rc=$?
        fail=1
        echo "[$f $(( $(date +%s) - ts ))s] FAILED rc=$rc"
        tail -15 /tmp/shard.log | sed 's/^/    /'
    fi
done
echo "total wall: $(( $(date +%s) - t0 )) s; overall: $([ $fail -eq 0 ] && echo PASS || echo FAIL)"
exit $fail
