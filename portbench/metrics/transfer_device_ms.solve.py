"""Device ms per V-cycle of the operations launched inside the transfers'
spans (``L<l>.restrict``, ``L<l>.prolong``), over the device stretch of
solves."""

from portbench import spans


def read(ctx):
    return spans.transfer_device_ms(ctx)
