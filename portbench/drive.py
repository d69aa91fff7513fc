"""The benchmark's one traffic generator. A traffic mix is a JSON file under
``portbench/traffic/`` whose ``"entry"`` names the program's entry point it
drives, and whose other keys are its parameters:

``"registry"``
    ``clients`` closed-loop clients, each sending one row through
    ``ServingRegistry.infer`` and waiting for its answer before the next;
    ``registry`` holds the batcher's settings (``max_batch``,
    ``max_delay_s``, ``max_queue``).
``"predict_q"``
    One caller calling ``CompiledModel.predict_q`` on one row, back to
    back (the per-call graph).
``"predict_q_many"``
    One caller scoring ``rows_per_call`` rows a call with
    ``CompiledModel.predict_q_many(xs, max_batch=max_batch)``.
``"registry_open"``
    An open loop through ``ServingRegistry.submit``: requests arrive at
    ``rate`` rows a second, with exponential gaps drawn from the seed
    (``arrivals: "poisson"``) or evenly (``"fixed"``), whether or not
    earlier ones were answered; each is timed from when it was due.

Every mix draws its rows from a pool of ``pool_rows`` distinct rows, in an
order drawn from the seed; ``warm_s`` seconds of the same traffic run
before the window and count as set-up. A run records, for every row
answered in the window, the row's pool index and the answer, so that the
check compares every answer with the reference's answer to that row.

With a device trace (``--trace 1``) the window has two phases: in the
first the program's spans and counters are read, in the last
``trace_s`` seconds the profiler records the device.
"""
from __future__ import annotations

import asyncio
import time
from array import array

import numpy as np

from portbench import model as M

PC = time.perf_counter


class Record:
    """What a window produced: every answer with its pool index, every
    request's latency, what raised, and the phases' counters. Answers are
    kept in flat buffers that the garbage collector does not walk, so that
    keeping them costs the window no collection pauses."""

    def __init__(self):
        self.idx = array("q")  # pool index of every row answered
        self.out = bytearray()  # the answers' int8 bytes, in that order
        self.lat = array("d")  # seconds from each call to its answer
        self.raised = 0      # rows whose call raised
        self.errors = {}     # error type -> rows
        self.attempted = 0   # rows sent in the window
        self.calls = 0       # calls made in the window
        self.t_start = self.t_close = 0.0
        self.phase_a = None  # {"s", "rows", "calls", "requests",
        #                       "counters"}: the first phase of a traced run
        self.trace = None    # devtrace summary, with "rows" and "calls"
        self.notes = {}      # counters printed before the result

    def answer(self, i: int, y, dt: float) -> None:
        self.idx.append(i)
        self.out += np.ascontiguousarray(y, np.int8).tobytes()
        self.lat.append(dt)

    def fail(self, rows: int, err: Exception) -> None:
        self.raised += rows
        name = type(err).__name__
        self.errors[name] = self.errors.get(name, 0) + rows


class Phases:
    """The window's clock, and in a traced run where it switches from
    counters to the profiler: ``trace_s`` seconds before its end."""

    def __init__(self, rec, seconds, trace_s, counters, devtrace):
        self.rec, self.counters, self.devtrace = rec, counters, devtrace
        self.t_start = PC()
        self.t_end = self.t_start + seconds
        self.t_switch = (self.t_end - trace_s if devtrace is not None
                         else None)
        self.base = counters()
        self.rows0 = self.calls0 = 0

    def due(self, now) -> bool:
        return self.t_switch is not None and now >= self.t_switch \
            and self.rec.phase_a is None

    def switch(self, rows: int, calls: int) -> None:
        """Close the counted phase and start the profiled one."""
        now = PC()
        after = self.counters()
        self.rec.phase_a = {
            "s": now - self.t_start, "rows": rows, "calls": calls,
            "requests": len(self.rec.lat),
            "counters": {k: after[k] - self.base[k] for k in after}}
        self.rows0, self.calls0 = rows, calls
        self.devtrace.start()

    def finish(self, rows: int, calls: int) -> None:
        if self.devtrace is None:
            return
        if self.rec.phase_a is None:  # a window too short to switch
            self.switch(rows, calls)
        trace = self.devtrace.stop()
        trace.update(rows=rows - self.rows0, calls=calls - self.calls0)
        self.rec.trace = trace


class Pool:
    """The mix's rows: ``pool_rows`` distinct int8 rows on the host, with
    the graph's leading batch dimension of 1, and the seeded order in which
    requests take them."""

    def __init__(self, config, qmodel, traffic, seed, device):
        n = int(traffic["pool_rows"])
        rows = M.make_frames(config, qmodel, seed, n, device)
        self.rows = rows.cpu().numpy()[:, None]
        rng = np.random.default_rng(M.sub_seed(seed, 3))
        self.order = rng.permutation(n)
        self.n, self.seed = n, seed
        self._k = 0

    def next_index(self) -> int:
        i = int(self.order[self._k % self.n])
        self._k += 1
        return i

    def next_block(self, size: int) -> int:
        """Start of the next ``size``-row block: blocks tile the pool, and
        the seeded order picks which one comes next."""
        blocks = self.n // size
        if blocks < 1:
            raise ValueError(f"pool of {self.n} rows < a call of {size}")
        start = int(self.order[self._k % blocks] % blocks) * size
        self._k += 1
        return start


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

class Direct:
    """``CompiledModel.predict_q`` on one row, back to back."""

    def __init__(self, traffic, model, pool, tracer):
        self.model, self.pool = model, pool

    def counters(self) -> dict:
        return {"h2d_bytes": self.model.h2d_bytes,
                "h2d_copies": self.model.h2d_copies}

    def loop(self, rec, until, phases=None):
        model, pool = self.model, self.pool
        rows = calls = 0
        while True:
            now = PC()
            if now >= until:
                break
            if phases is not None and phases.due(now):
                phases.switch(rows, calls)
            i = pool.next_index()
            t0 = PC()
            try:
                y = model.predict_q(pool.rows[i])
            except Exception as err:  # a failed request, counted
                rec.fail(1, err)
            else:
                rec.answer(i, y, PC() - t0)
                rows += 1
            calls += 1
        rec.attempted += calls
        rec.calls += calls
        return rows, calls

    def warm(self, seconds):
        self.loop(Record(), PC() + seconds)

    def window(self, rec, seconds, phases):
        rows, calls = self.loop(rec, phases.t_end, phases)
        rec.t_close = PC()
        phases.finish(rows, calls)

    def close(self):
        self.model = None


class Many(Direct):
    """``CompiledModel.predict_q_many`` on ``rows_per_call`` rows a call."""

    def __init__(self, traffic, model, pool, tracer):
        super().__init__(traffic, model, pool, tracer)
        self.rows_per_call = int(traffic["rows_per_call"])
        self.max_batch = int(traffic["max_batch"])
        self.call_s = 0.0

    def counters(self) -> dict:
        return {**super().counters(), "call_s": self.call_s}

    def loop(self, rec, until, phases=None):
        model, pool, n = self.model, self.pool, self.rows_per_call
        chunks = -(-n // self.max_batch)
        rows = calls = 0
        while True:
            now = PC()
            if now >= until:
                break
            if phases is not None and phases.due(now):
                phases.switch(rows, calls)
            lo = pool.next_block(n)
            t0 = PC()
            try:
                ys = model.predict_q_many(pool.rows[lo:lo + n],
                                          max_batch=self.max_batch)
            except Exception as err:  # the call's rows failed, counted
                rec.fail(n, err)
            else:
                dt = PC() - t0
                self.call_s += dt
                rec.lat.append(dt)
                rec.idx.extend(range(lo, lo + n))
                rec.out += np.ascontiguousarray(ys, np.int8).tobytes()
                rows += n
            calls += chunks
            rec.attempted += n
        rec.calls += calls
        return rows, calls


class Served(Direct):
    """Closed-loop clients through ``ServingRegistry.infer``."""

    def __init__(self, traffic, model, pool, tracer):
        from repro_torch.serve.registry import ServingRegistry
        self.pool = pool
        self.clients = int(traffic.get("clients", 0))
        kw = dict(traffic["registry"])
        if self.clients > int(kw["max_queue"]):
            raise ValueError("more clients than max_queue: the batcher "
                             "could shed a request")
        self.tracer = tracer
        self.registry = ServingRegistry(tracer=tracer, **kw)
        self.model = self.registry.register("m", model)
        self.metrics = self.registry.metrics("m")
        self.loop_ = asyncio.new_event_loop()
        self.loop_.run_until_complete(self._start())

    async def _start(self):
        self.registry.start()

    def counters(self) -> dict:
        m = self.metrics
        out = {**super().counters(), "batches": m.batches,
               "batched_rows": m.batched_rows, "call_s": m.infer_s}
        if self.tracer is not None:
            h = self.tracer.hists["queue"]
            out.update(queue_sum_us=h.sum_us, queue_n=h.n)
        return out

    async def _clients(self, rec, until, phases):
        pool, reg = self.pool, self.registry
        sent = [0]

        async def client():
            while PC() < until:
                i = pool.next_index()
                t0 = PC()
                sent[0] += 1
                try:
                    y = await reg.infer("m", pool.rows[i])
                except Exception as err:  # a failed request, counted
                    rec.fail(1, err)
                    continue
                rec.answer(i, y, PC() - t0)

        async def switch():
            await asyncio.sleep(max(0.0, phases.t_switch - PC()))
            # flushes run on the loop (the inline executor), so none is in
            # flight here: the counters split exactly at the switch
            phases.switch(self.metrics.batched_rows - rows0,
                          self.metrics.batches - flushes0)

        rows0, flushes0 = self.metrics.batched_rows, self.metrics.batches
        tasks = [asyncio.ensure_future(client())
                 for _ in range(self.clients)]
        if phases is not None and phases.t_switch is not None:
            tasks.append(asyncio.ensure_future(switch()))
        await asyncio.gather(*tasks)
        rec.t_close = PC()
        rec.attempted += sent[0]
        rec.calls += self.metrics.batches - flushes0
        return (self.metrics.batched_rows - rows0,
                self.metrics.batches - flushes0)

    def warm(self, seconds):
        self.loop_.run_until_complete(
            self._clients(Record(), PC() + seconds, None))

    def window(self, rec, seconds, phases):
        rows, calls = self.loop_.run_until_complete(
            self._clients(rec, phases.t_end, phases))
        phases.finish(rows, calls)
        m = self.metrics
        rec.notes["batcher"] = {"rejected": m.rejected,
                                "preempted": m.preempted,
                                "deadline_exceeded": m.deadline_exceeded,
                                "failed": m.failed}

    def close(self):
        self.loop_.run_until_complete(self.registry.stop())
        self.loop_.close()
        self.registry = self.model = None


class Open(Served):
    """Requests on a schedule through ``ServingRegistry.submit``."""

    def __init__(self, traffic, model, pool, tracer):
        super().__init__(traffic, model, pool, tracer)
        self.rate = float(traffic["rate"])
        self.poisson = traffic.get("arrivals", "poisson") == "poisson"
        self.gaps = np.random.default_rng(M.sub_seed(pool.seed, 4))
        self.late_s = 0.0  # how far behind its schedule the sender ran

    def counters(self) -> dict:
        return {**super().counters(), "late_s": self.late_s}

    def window(self, rec, seconds, phases):
        super().window(rec, seconds, phases)
        rec.notes["sender_late_s"] = self.late_s

    async def _clients(self, rec, until, phases):
        pool, reg, m = self.pool, self.registry, self.metrics
        rows0, flushes0 = m.batched_rows, m.batches
        waiting = []
        sent = 0

        def done(fut, i, due):
            if fut.cancelled():
                return
            err = fut.exception()
            if err is not None:
                rec.fail(1, err)
            else:
                rec.answer(i, fut.result(), PC() - due)

        def gap():
            return (self.gaps.exponential(1.0 / self.rate) if self.poisson
                    else 1.0 / self.rate)

        due = PC() + gap()
        while due < until:
            now = PC()
            if due > now:
                await asyncio.sleep(due - now)
                now = PC()
            self.late_s = max(self.late_s, now - due)
            if phases is not None and phases.due(now):
                phases.switch(m.batched_rows - rows0, m.batches - flushes0)
            # every request due by now goes out at this wake-up, as a
            # socket read hands over what arrived; the batcher's task runs
            # at the next await
            while due <= now and due < until:
                i = pool.next_index()
                sent += 1
                try:
                    fut = reg.submit("m", pool.rows[i])
                except Exception as err:  # refused at admission: counted
                    rec.fail(1, err)
                else:
                    fut.add_done_callback(
                        lambda f, i=i, d=due: done(f, i, d))
                    waiting.append(fut)
                due += gap()
            await asyncio.sleep(0)
        await asyncio.gather(*waiting, return_exceptions=True)
        rec.t_close = PC()
        rec.attempted += sent
        rec.calls += m.batches - flushes0
        return m.batched_rows - rows0, m.batches - flushes0


ENTRIES = {"predict_q": Direct, "predict_q_many": Many, "registry": Served,
           "registry_open": Open}


def driver(traffic, model, pool, tracer=None):
    try:
        cls = ENTRIES[traffic["entry"]]
    except KeyError:
        raise ValueError(f"unknown entry {traffic['entry']!r}; "
                         f"known: {sorted(ENTRIES)}") from None
    return cls(traffic, model, pool, tracer)
