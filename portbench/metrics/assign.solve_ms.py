"""assign.solve_ms: device milliseconds of the auction kernels per
assignment solve in the traced fit, whatever route the band guard took
(the resident, streamed, large and banded kernels' launch counters count
the solves, the guard's probes among them)."""

SOLVERS = ("auction_solve_resident", "auction_solve_resident_hbm",
           "auction_solve_large", "auction_solve_banded")


def read(ctx):
    calls = ctx["traced"]["launches"]
    solves = sum(calls[k] for k in SOLVERS)
    seconds, _ = ctx["trace"].seconds_of("auction")
    if solves <= 0 or seconds <= 0:
        return None
    return 1e3 * seconds / solves
