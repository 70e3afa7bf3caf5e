#!/usr/bin/env bash
# Serving launcher with process-group lifecycle management — the operational
# role of the reference's kiosk launcher (launch_on_pi.sh:35-71,100-116):
# start the control-plane server, wait for the socket, clean shutdown of the
# whole group on exit.
set -euo pipefail

WS_PORT="${WS_PORT:-8765}"
ENGINE_COUNT="${ENGINE_COUNT:-1}"
SLOT="${SLOT:-A}"
POOL_CAPACITY="${POOL_CAPACITY:-2}"
LOG_LEVEL="${LOG_LEVEL:-info}"

cleanup() {
  # kill the whole process group like the reference launcher
  local pids
  pids=$(jobs -p)
  [ -n "$pids" ] && kill $pids 2>/dev/null || true
  wait 2>/dev/null || true
}
trap cleanup EXIT INT TERM

python -m bauklank serve \
  --engine-count "$ENGINE_COUNT" --slot "$SLOT" \
  --ws-port "$WS_PORT" --pool-capacity "$POOL_CAPACITY" \
  --startup-log-level "$LOG_LEVEL" --run-log-level "$LOG_LEVEL" &
SERVER_PID=$!

# wait for the websocket to accept connections (curl poll like the reference)
for _ in $(seq 1 60); do
  if python - "$WS_PORT" <<'EOF'
import socket, sys
s = socket.socket()
s.settimeout(0.5)
try:
    s.connect(("127.0.0.1", int(sys.argv[1])))
except OSError:
    sys.exit(1)
EOF
  then
    echo "server up on ws://0.0.0.0:${WS_PORT}"
    break
  fi
  sleep 1
done

wait "$SERVER_PID"
