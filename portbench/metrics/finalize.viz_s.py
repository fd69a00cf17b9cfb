"""finalize.viz_s: seconds of the artifacts a sequence (the program's
`finalize/viz` phase timer, summed over the window, over the sequences in
it): recon.gif, gt.gif, seg.html and structure.html, on the host."""


def read(ctx):
    win = ctx["window"]
    seconds = win.get("phases", {}).get("finalize/viz")
    if seconds is None or win["units"] <= 0:
        return None
    return seconds / win["units"]
