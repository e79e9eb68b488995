"""A recorded sequence mapped as fast as it goes: ``SlamSession.run`` in
chunks (``session.chunk`` frames a replay of one captured graph, pipelined
as the program pipelines them), ``session.block_chunks`` chunks a call."""

from __future__ import annotations

from slambench import driving


class Route:
    def __init__(self, ctx: driving.Ctx):
        from cv_monoslam_tpu_torch.api import SlamSession

        self.ctx = ctx
        s = ctx.session
        self.chunk = int(s["chunk"])
        self.block = self.chunk * int(s["block_chunks"])
        self.sess = SlamSession(ctx.cfg, ctx.seq, ctx.track,
                                device=ctx.device)

    def warm(self) -> None:
        """Capture the cell's chunk graphs: with the host gate, the detect
        chunk and then, the gate forced shut, the tracking chunk; then one
        block through ``run``."""
        sess, s = self.sess, self.ctx.session
        if s.get("detect_host_gate"):
            sess.detect_host_gate = True
            sess.step_chunk(self.chunk)
            sess._last_matched = self.ctx.cfg.min_num
            sess.step_chunk(self.chunk)
            sess._last_matched = sess.records[-1].n_matched
            sess.detect_gate_margin = s.get("detect_gate_margin")
        else:
            sess.step_chunk(self.chunk)
        self._run(self.block)

    def _run(self, n: int) -> None:
        sess = self.sess
        if sess.counter + n > len(sess.track):
            raise RuntimeError(f"the odometry ends at row {len(sess.track)}:"
                               f" the window outran it")
        sess.run(n_frames=n, chunk=self.chunk, drop_tail=True)

    def window(self, seconds: float, plan: driving.Plan) -> driving.Window:
        sess, dev = self.sess, self.ctx.device
        n0 = len(sess.records)
        d0 = len(sess.chunk_detect)
        first = sess.counter
        before = sess.records[-1] if sess.records else None
        samples, attempted = [], 0
        driving.sync(dev)
        t0 = driving.clock()
        while True:
            elapsed = driving.clock() - t0
            more, sampled = self._decide(elapsed < seconds,
                                         plan.due(elapsed))
            if not more:
                break
            if sampled:
                samples.append(self._sampled_chunk())
                attempted += self.chunk
            else:
                self._run(self.block)
                attempted += self.block
        driving.sync(dev)
        wall = driving.clock() - t0
        recs = sess.records[n0:]
        h = driving.health(recs, before)
        h["detect_chunks"] = (sum(sess.chunk_detect[d0:]),
                              len(sess.chunk_detect) - d0)
        return driving.Window(
            frames=len(recs), attempted=attempted,
            failed=h["failed"] + attempted - len(recs), wall_s=wall,
            samples=samples, first_frame=first, health=h)

    def _decide(self, more: bool, sampled: bool) -> tuple:
        """Whether the window goes on, and whether this iteration keeps a
        sample (one process decides alone)."""
        return more, sampled

    def _sampled_chunk(self) -> driving.Sample:
        """One chunk through ``run``, the program's state kept before and
        after it and the telemetry of each of its frames."""
        sess = self.sess
        k = sess.counter
        before = driving.to_host(sess.state)
        kept = {}
        post = sess._post_frame

        def keep(rec, tele):
            kept[rec.frame] = tele
            post(rec, tele)

        sess._post_frame = keep
        try:
            self._run(self.chunk)
        finally:
            del sess._post_frame
        later = driving.to_host(sess.state)
        frames = range(k, k + self.chunk)
        return driving.Sample(
            frame=k, images=[self.ctx.frames[int(sess.track.frame_id[f])]
                             for f in frames],
            allow_detect=bool(sess.chunk_detect[-1]), before=before,
            teles=[kept.get(f) for f in frames], later=later)

    def stretch(self) -> int:
        sess = self.sess
        n0, d0 = len(sess.records), len(sess.chunk_detect)
        self._run(int(self.ctx.traffic["trace_frames"]))
        self.stretch_detect = (sum(sess.chunk_detect[d0:]),
                               len(sess.chunk_detect) - d0)
        return len(sess.records) - n0

    def release(self) -> None:
        self.sess = None
