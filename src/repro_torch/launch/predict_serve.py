"""Prediction-serving launcher (the sweep-pricing counterpart of
``launch.serve``'s token-generation driver).

    # start the server (ephemeral port prints on stdout)
    PYTHONPATH=src python -m repro_torch.launch.predict_serve serve --port 8707

    # also open the framed persistent-socket transport (binary framing
    # v1; --binary-port 0 picks an ephemeral port, printed as a second
    # banner) and cap the coalescer's adaptive fused-row budget
    PYTHONPATH=src python -m repro_torch.launch.predict_serve serve \
        --port 8707 --binary-port 8708 --max-fused-rows 65536

    # query it from another shell / machine (--transport binary pins the
    # framed socket; the default auto-negotiates via /v1/health)
    PYTHONPATH=src python -m repro_torch.launch.predict_serve query health
    PYTHONPATH=src python -m repro_torch.launch.predict_serve query argmin-demo \
        --hw b200 --gemm 8192,8192,8192

Thin wrapper: ``serve`` is ``repro_torch.serve.server.main`` and ``query`` is
``repro_torch.serve.client.main`` — both accept the same flags here as when
run as modules directly.
"""
from __future__ import annotations

import sys


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        from ..serve.server import main as serve_main
        serve_main(rest)
    elif cmd == "query":
        from ..serve.client import main as query_main
        query_main(rest)
    else:
        raise SystemExit(
            f"unknown command {cmd!r}: expected 'serve' or 'query'")


if __name__ == "__main__":
    main()
