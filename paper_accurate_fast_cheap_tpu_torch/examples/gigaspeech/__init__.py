"""GigaSpeech recipe drivers; they read ``examples/gigaspeech/conf/``."""
