"""launches_per_pose: device activities (kernels, copies, sets) in the
profiled part of a replay (the traffic's ``profile_part`` of its stream)
over the poses fed in that part."""


def read(ctx):
    if not ctx.trace.n_device or not ctx.part_work:
        return None
    return ctx.trace.n_device / ctx.part_work
