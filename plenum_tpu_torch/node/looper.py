"""Real-time runner: drives a Node (or several) on an asyncio event loop.

Reference behavior: stp_core/loop/looper.py — a Looper owns Prodables and
calls prod() on each in a run-forever loop, interleaved with the event loop
so socket I/O and timers stay live. Here the transport IS asyncio, so the
Looper is small: one task per node that services the shared QueueTimer,
drains the node's transport stacks, and prods the node, sleeping
prod_interval between cycles (long sleeps would add ordering latency; the
interval is the reference's prodable loop granularity).
"""
from __future__ import annotations

import asyncio
import time
from typing import Callable, Optional

from plenum_tpu_torch.common.timer import QueueTimer


class Prodable:
    """One runnable unit: a node plus its transport stacks."""

    def __init__(self, node, node_stack=None, client_stack=None,
                 timer: Optional[QueueTimer] = None):
        self.node = node
        self.node_stack = node_stack
        self.client_stack = client_stack
        self.timer = timer

    async def start(self) -> None:
        if self.node_stack is not None:
            await self.node_stack.start()
        if self.client_stack is not None:
            await self.client_stack.bind()

    async def stop(self) -> None:
        if self.node_stack is not None:
            await self.node_stack.stop()
        if self.client_stack is not None:
            await self.client_stack.stop()

    def prod(self) -> int:
        count = 0
        if self.timer is not None:
            count += self.timer.service()
        if self.node_stack is not None:
            count += self.node_stack.drain()
        if self.client_stack is not None:
            count += self.client_stack.drain()
        count += self.node.prod()
        return count


class Looper:
    """Runs Prodables until stopped; usable as an async context manager
    inside an existing event loop (tests) or via run() standalone (the
    start-node script)."""

    def __init__(self, prod_interval: float = 0.002):
        self.prod_interval = prod_interval
        self._prodables: list[Prodable] = []
        self._tasks: list[asyncio.Task] = []
        self._running = False

    def add(self, prodable: Prodable) -> None:
        self._prodables.append(prodable)
        if self._running:
            # late-added prodables must bind/dial their stacks first
            async def start_then_drive():
                await prodable.start()
                await self._drive(prodable)

            self._tasks.append(
                asyncio.get_running_loop().create_task(start_then_drive()))

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.shutdown()

    async def start(self) -> None:
        self._running = True
        for p in self._prodables:
            await p.start()
        loop = asyncio.get_running_loop()
        self._tasks = [loop.create_task(self._drive(p))
                       for p in self._prodables]

    async def _drive(self, prodable: Prodable) -> None:
        while self._running:
            busy = prodable.prod()
            # busy cycles yield to the loop but don't sleep the full interval
            await asyncio.sleep(0 if busy else self.prod_interval)

    async def run_until(self, predicate: Callable[[], bool],
                        timeout: float) -> bool:
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if predicate():
                return True
            await asyncio.sleep(self.prod_interval)
        return predicate()

    async def shutdown(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        for p in self._prodables:
            await p.stop()
        self._tasks.clear()

    def run(self, coro) -> None:
        """Standalone entry: run a main coroutine with this looper started."""
        async def _main():
            async with self:
                await coro

        asyncio.run(_main())
