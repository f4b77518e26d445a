"""Training under a runtime's trainer (counterpart of ``ray_tpu/train``):
the device batch feeder (``session``) and the sharded GPT train loop
(``loop``)."""
