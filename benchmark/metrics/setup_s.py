"""Seconds from process start to the first timed operation (host clock)."""


def read(record):
    return record["setup_s"]
