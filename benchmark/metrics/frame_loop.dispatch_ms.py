"""frame_loop.dispatch_ms: the mean host time of the calls the frame loop
makes into render/pipeline.py::render_frame_constants, over the traced
window's frames (host clock, no synchronize): the host's dispatch of one
frame's launches."""


def read(run):
    if not run.dispatch_s:
        return None
    return 1e3 * sum(run.dispatch_s) / len(run.dispatch_s)
