"""finalize.energy_s: seconds of the selection energy a sequence (the
program's `finalize/energy` phase timer, summed over the window, over the
sequences in it): the exact host LAP and its presolve on the card."""


def read(ctx):
    win = ctx["window"]
    seconds = win.get("phases", {}).get("finalize/energy")
    if seconds is None or win["units"] <= 0:
        return None
    return seconds / win["units"]
