"""peak_device_gib: torch.cuda.max_memory_allocated() over the window
(reset at its start; the staged inputs count), in GiB."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 2**30
