"""device_kernels_per_call: device operations (kernels, copies and sets;
a CUDA graph's nodes count one by one) per traced call."""


def read(run):
    if not run.device_events or not run.traced_calls:
        return None
    return len(run.device_events) / run.traced_calls
