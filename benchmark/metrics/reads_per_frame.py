"""Device->host reads the program made per frame of the window, counted
with torch.cuda.set_sync_debug_mode (benchmark/trace.py's SyncCounter);
the stage timers' own synchronisations of the traced run left out."""


def read(ctx):
    syncs = ctx.get("syncs")
    return sum(syncs) / len(syncs) if syncs else None
