"""The paper's example drivers, ported (``examples/gigaspeech/local/``)."""
