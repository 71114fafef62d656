"""upload_gbps: GB/s of the entry's upload of one call's host frames
(``torch.as_tensor(frames).to(device)``, pageable: CUDA stages it through
the host's memory), a CUDA-event span from the harness, the median of
``stage_repeats``. Nothing where the frames are on the device."""


def read(t):
    return t["stages"].get("upload_gbps")
