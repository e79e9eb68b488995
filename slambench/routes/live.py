"""A live camera: one ``SlamSession.step()`` a frame, closed loop (the next
frame is handed over when the previous pose is back on the host); each
frame's latency by the host clock around the call."""

from __future__ import annotations

from slambench import driving

#: frames stepped after the step graph's capture, before the window
WARM_STEPS = 8


class Route:
    def __init__(self, ctx: driving.Ctx):
        from cv_monoslam_tpu_torch.api import SlamSession

        self.ctx = ctx
        self.sess = SlamSession(ctx.cfg, ctx.seq, ctx.track,
                                device=ctx.device)

    def warm(self) -> None:
        """Capture the step graph and run a few frames through it."""
        for _ in range(WARM_STEPS):
            self._step()

    def _step(self):
        rec = self.sess.step()
        if rec is None:
            raise RuntimeError("the odometry ended: the window outran it")
        return rec

    def window(self, seconds: float, plan: driving.Plan) -> driving.Window:
        sess, dev = self.sess, self.ctx.device
        M = self.ctx.cfg.max_landmarks
        n0 = len(sess.records)
        first = sess.counter
        before_rec = sess.records[-1] if sess.records else None
        lat, samples, it = [], [], 0
        clock = driving.clock
        driving.sync(dev)
        t0 = clock()
        while True:
            elapsed = clock() - t0
            if elapsed >= seconds:
                break
            sampled = plan.due(elapsed)
            if sampled:
                k = sess.counter
                before = driving.to_host(sess.state)
            t = clock()
            rec = self._step()
            lat.append(clock() - t)
            if sampled:
                after = driving.to_host(sess.state)
                # the pose as the caller got it, the rest from the state
                tele = {**driving.state_tele(after, M), "pose": rec.pose,
                        "pose_sqrt_cov": rec.pose_sqrt_cov}
                samples.append(driving.Sample(
                    frame=k,
                    images=[self.ctx.frames[int(sess.track.frame_id[k])]],
                    allow_detect=True, before=before, teles=[tele],
                    later=after))
            it += 1
        driving.sync(dev)
        wall = clock() - t0
        recs = sess.records[n0:]
        h = driving.health(recs, before_rec)
        return driving.Window(
            frames=len(recs), attempted=it,
            failed=h["failed"] + it - len(recs), wall_s=wall,
            latencies_s=lat, samples=samples, first_frame=first, health=h)

    def stretch(self) -> int:
        n = int(self.ctx.traffic["trace_frames"])
        for _ in range(n):
            self._step()
        return n

    def release(self) -> None:
        self.sess = None
