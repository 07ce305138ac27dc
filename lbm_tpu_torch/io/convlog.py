"""CONVERGENCE.log writer (ldc.cu:616-617,679,691; bifurcation README:
'CONVERGENCE.log records the convergence')."""

from __future__ import annotations

import os


class ConvergenceLog:
    def __init__(self, out_dir: str, filename: str = "CONVERGENCE.log"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._fh = open(self.path, "w")

    def residual(self, value: float) -> None:
        self._fh.write(f"{value:g}\n")
        self._fh.flush()

    def finish(self, elapsed_ms: float, nlattice: int, residual: float) -> None:
        self._fh.write(
            f"TOTAL RUNNING TIME: {elapsed_ms:g} MILLI SECONDS"
            f"#LATTICE{nlattice} ERROR IS{residual:g}\n"
        )
        self._fh.close()


__all__ = ["ConvergenceLog"]
