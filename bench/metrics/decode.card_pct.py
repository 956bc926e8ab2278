"""``decode.card_pct``: % of the run's CIGAR pairs whose packed trace was
decoded on the card (``SessionStats.n_tb_card``: the traceback kernel,
``csrc/wfa_traceback.cu``) rather than walked on the host
(``n_tb_host``: ``core/cigar.py``); how often the card's decode engages.
None where the program keeps no such counters or decoded no pair."""


def read(run):
    card = getattr(run.stats, "n_tb_card", None)
    host = getattr(run.stats, "n_tb_host", None)
    if card is None or host is None or not card + host:
        return None
    return 100.0 * card / (card + host)
