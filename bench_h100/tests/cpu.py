"""Helpers of the CPU tests: a cell of the benchmark cut to a size the CPU
proves in seconds (the program's kernels run as their plain twins there)."""

import torch

from bench_h100.spec import Cell, load

CPU = torch.device("cpu")


def small_cell(workload: str, bn: int = 4, lanes: int = 1, check_proofs: int = 1) -> Cell:
    cell = Cell(load(), workload)
    cell.traffic = dict(cell.traffic, bn=bn, lanes=lanes, mode="grouped" if lanes > 1 else "single",
                        check_proofs=check_proofs)
    return cell
