"""ingest_s: seconds in models/base.py:_BaseModel._ingest_X over one fit
(the scipy matrix to COO triplets), synchronized at its end."""

SPANS = {"ingest": "cmfrec_torch.models.base:_BaseModel._ingest_X"}


def read(run):
    return run.spans.get("ingest")
