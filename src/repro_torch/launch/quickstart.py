"""Quickstart: the PAX ABI in five minutes — the port's twin of the
reference's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

1. start a world of one and initialize the ABI with a byte-counting tool
   stacked (pick an implementation: the paper's point is that this choice
   never touches your code);
2. query the bit-encoded handles;
3. run an allreduce and an allgather over the data-parallel communicator;
4. register a user-defined reduction (the callback surface);
5. read the tool's byte ledger.
"""
from __future__ import annotations

import argparse

import torch

from .. import core as C
from ..runtime.device import resolve_device
from ..runtime.dist import init_world


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--impl", default="paxi", help="PAX ABI backend")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    started = init_world(dev)
    mesh = C.Mesh(("data", "model"), (1, 1), dev)

    # --- 1. init with tools stacked (works identically for any impl) ---------
    counter = C.ByteCounter()
    abi = C.pax_init(mesh, impl=args.impl, tools=[counter])
    print("implementation:", abi.backend.name, "| available:", C.available_backends())
    try:
        # --- 2. handles: bit-encoded metadata (paper §5.4 / A.3) -------------
        print("PAX_FLOAT32 =", bin(C.PAX_FLOAT32), "-> size", abi.type_size(C.PAX_FLOAT32))
        print("PAX_BFLOAT16 =", bin(C.PAX_BFLOAT16), "-> size",
              abi.type_size(C.PAX_BFLOAT16))
        print("describe(PAX_SUM) =", C.describe(C.PAX_SUM))

        # --- 3. collectives over mesh-axis communicators -------------------------
        dp = abi.comm_from_axes(("data",), "dp")
        x = torch.arange(4.0, device=dev)
        y = abi.allreduce(x * 2, C.PAX_SUM, dp)
        z = abi.allgather(x, dp)
        print("allreduce:", y.cpu().numpy(), "| allgather:", z.cpu().numpy())

        # --- 4. user-defined op (callback through the ABI) -----------------------
        l2 = abi.op_create(lambda a, b: torch.sqrt(a * a + b * b), name="l2")
        u = abi.allreduce(torch.ones(3, device=dev) * 3, l2, dp)
        print("user op result:", u.cpu().numpy())

        # --- 5. the tool saw every call -------------------------------------------
        print("tool ledger:", dict(counter.bytes), "total bytes:", counter.total())
        return {"allreduce": y.cpu(), "allgather": z.cpu(), "user_op": u.cpu(),
                "ledger": dict(counter.bytes)}
    finally:
        abi.release()
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
