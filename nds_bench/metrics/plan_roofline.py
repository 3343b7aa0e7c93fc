"""The least time the cards could take over the tasks completed in the traced
window (each input byte read once, each output byte written once, from their
shapes, at the card's published memory rate) as a share of the time the cards
were busy in that window (the union of each card's device intervals, the
mean over the cards times their number)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.done:
        return None
    least = sum(r.least_bytes for r in run.done) / run.rates[0]
    return 100.0 * least / (run.trace.busy_s * run.chips)
