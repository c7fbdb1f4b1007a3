"""Word-count example custom app: the minimal end-to-end demonstration
of the framework API (counterpart of ``oryx_tpu/example/``; reference:
app/example/ — a custom app counts, for each word, the distinct other
words that co-occur on a line).  Its configuration is
``oryx_tpu_torch/conf/wordcount-example.conf``."""
