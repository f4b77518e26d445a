"""The port's runtime internals (counterpart of ``ray_tpu/_private``)."""
