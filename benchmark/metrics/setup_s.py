"""Process start to the first timed fit: imports, the card's context, the
kernel library, the tables, the frame basis and the warm-up fits."""


def read(rec):
    return rec["setup_s"]
