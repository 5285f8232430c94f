"""Device time of named submodules of the program, from CUDA events that
forward hooks record around each call on the current stream. Off the card
nothing is recorded and every total is None."""

from __future__ import annotations

import torch


class ModuleTimer:
    def __init__(self, modules: dict, device):
        """modules: {name: [torch modules]}, all timed under `name`."""
        self.device = device
        self.events = {name: [] for name in modules}
        self.handles = []
        if device.type != "cuda":
            return
        for name, mods in modules.items():
            for mod in mods:
                self.handles.append(mod.register_forward_pre_hook(
                    self._pre(name)))
                self.handles.append(mod.register_forward_hook(
                    self._post(name)))

    def _pre(self, name):
        def hook(module, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.events[name].append([ev, None])
        return hook

    def _post(self, name):
        def hook(module, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.events[name][-1][1] = ev
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []

    def total_ms(self) -> dict:
        """{name: device ms summed over every call, or None}."""
        if self.device.type != "cuda":
            return dict.fromkeys(self.events)
        torch.cuda.synchronize(self.device)
        return {name: sum(a.elapsed_time(b) for a, b in evs)
                for name, evs in self.events.items()}
