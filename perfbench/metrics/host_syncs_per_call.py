"""host_syncs_per_call: the synchronizing calls torch's sync debug mode
reports inside the entry, per call, over the traced run's sync-counted
calls (those after the profiled ones, not under the profiler).  The
harness's own synchronize after each call is not counted, nor are syncs
made inside native libraries (cuSOLVER's info reads, the kernels' own)."""


def read(run):
    if not run.sync_calls:
        return None
    return run.syncs / run.sync_calls
