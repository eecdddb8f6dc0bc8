"""Host-side simulation runner and HDF5 data handling, in PyTorch.

Port of :mod:`tdgl_tpu.solver.runner`. The on-disk schema matches the
reference (``tdgl/solver/runner.py:29-183``): ``mesh/`` (the FV mesh),
root-level fixed arrays, and per-snapshot groups ``data/<n>`` with state
attrs (step/time/dt), full state arrays, and a ``running_state`` subgroup
of per-step scalars, plus the ``checkpoint`` group of the full solver
state. The file is written through :mod:`tdgl_tpu_torch.utils.h5lite`.

Beside it, as in the JAX runner, the ``<file>.h5.tmp`` side file holds
the latest snapshot under ``data/-1`` (with ``step``/``time``/``dt``
datasets), the fixed arrays and ``solution/device``, for the live monitor
(:func:`tdgl_tpu_torch.visualization.monitor_solution`), and is removed
on close. The JAX package writes it with h5py's SWMR mode; h5lite has no
SWMR, so every snapshot after the first overwrites the side file's
datasets in place: after that snapshot's flush no header, superblock or
data block moves, and a reader that opens the file anew at any time reads
it whole (a ``psi`` may mix two snapshots, as under SWMR).

The device advances up to ``save_every`` steps per ``chunk_fn`` call; the
host reads from the device once per chunk: the chunk's stacked per-step
outputs and its exported state (and, at a snapshot, the full state for the
checkpoint). Differences from the JAX runner: progress goes through the
logger, or a tqdm bar where tqdm is installed; ``profile_dir`` writes a
``torch.profiler`` chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import subprocess
import sys
import tempfile
import time as _time
import traceback
from datetime import datetime
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils import h5lite
from .options import SolverOptions
from .step import StepOutputs

logger = logging.getLogger(__name__)


def to_host(tensor) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


class DataHandler:
    """Context manager owning the output HDF5 file and its ``.tmp`` side
    file."""

    def __init__(self, output_file: Optional[str],
                 logger: Optional[logging.Logger] = None):
        self.tempdir = None
        self.save_number = 0
        self.logger = logger or logging.getLogger(__name__)
        self._base_output_file = output_file
        self.output_file: Optional[h5lite.File] = None
        self.output_path: Optional[str] = None
        self.tmp_file: Optional[h5lite.File] = None
        self.tmp_path: Optional[str] = None
        self.time_step_group: Optional[h5lite.Group] = None
        self.mesh_group: Optional[h5lite.Group] = None

    def _create_output_file(self, output: Optional[str]):
        if output is None:
            self.tempdir = tempfile.TemporaryDirectory()
            directory, name, suffix = self.tempdir.name, "output", "h5"
        else:
            Path(output).parent.mkdir(parents=True, exist_ok=True)
            parts = output.split(".")
            name, suffix = ".".join(parts[:-1]), parts[-1]
            directory = os.getcwd()
        serial = None
        while True:
            tag = f"-{serial}" if serial is not None else ""
            file_name = f"{name}{tag}.{suffix}"
            path = os.path.join(directory, file_name)
            tmp_path = path + ".tmp"
            try:
                f = h5lite.File(path, "x")
            except FileExistsError:
                serial = 1 if serial is None else serial + 1
                continue
            try:
                tmp = h5lite.File(tmp_path, "x")
            except FileExistsError:
                # Another run's side file: take the next name for both.
                f.close()
                os.remove(path)
                serial = 1 if serial is None else serial + 1
                continue
            if serial is not None:
                self.logger.warning(
                    f"Output file already exists; renamed to {file_name}."
                )
            return f, path, tmp, tmp_path

    def __enter__(self) -> "DataHandler":
        (self.output_file, self.output_path, self.tmp_file,
         self.tmp_path) = self._create_output_file(self._base_output_file)
        self.time_step_group = self.output_file.create_group(
            "data", track_order=True
        )
        grp = self.tmp_file.create_group("data/-1")
        grp["step"] = np.array([0])
        grp["time"] = np.array([0.0])
        grp["dt"] = np.array([0.0])
        return self

    def __exit__(self, exc_type, exc_value, exc_tb) -> None:
        if exc_value is not None:
            self.logger.warning(
                "Ignoring exception in DataHandler.__exit__():\n%s",
                "".join(traceback.format_exception(exc_type, exc_value,
                                                   exc_tb)),
            )
        self.close()

    def close(self) -> None:
        if self.output_file is not None:
            self.output_file.close()
        if self.tmp_file is not None:
            self.tmp_file.close()
            try:
                os.remove(self.tmp_path)
            except OSError:
                pass
        if self.tempdir is not None:
            self.tempdir.cleanup()

    def save_mesh(self, mesh) -> None:
        """Save the mesh under ``mesh/``."""
        self.mesh_group = self.output_file.create_group("mesh")
        mesh.to_hdf5(self.mesh_group)

    def save_fixed_values(self, fixed_data: Dict[str, np.ndarray]) -> None:
        """Save time-independent arrays at the root of both files."""
        for key, value in fixed_data.items():
            value = np.asarray(value)
            self.output_file[key] = value
            self.tmp_file[key] = value

    def save_device(self, device) -> None:
        """Write the device into the side file (``solution/device``, which
        the monitor reads its mesh from) and flush it, so the monitor can
        draw before the first snapshot."""
        device.to_hdf5(self.tmp_file.create_group("solution/device"))
        self.tmp_file.flush()

    def save_time_step(
        self,
        state: Dict[str, float],
        data: Dict[str, np.ndarray],
        running_state: Optional[Dict[str, np.ndarray]],
    ) -> None:
        """Append one snapshot group ``data/<n>``."""
        group = self.time_step_group.create_group(f"{self.save_number}")
        group.attrs["timestamp"] = datetime.now().isoformat()
        self.save_number += 1
        for key, value in state.items():
            group.attrs[key] = value
        tmp_grp = self.tmp_file["data/-1"]
        for key, value in data.items():
            value = np.asarray(value)
            group[key] = value
            if key in tmp_grp:
                tmp_grp[key][:] = value
            else:
                tmp_grp[key] = value
        # The arrays first, then the step: a reader that sees a new step
        # finds this snapshot's arrays written.
        self.tmp_file.flush()
        for key in ("step", "time", "dt"):
            tmp_grp[key][:] = np.array([state[key]])
        self.tmp_file.flush()
        if running_state is not None:
            rs_grp = group.create_group("running_state")
            for key, value in running_state.items():
                rs_grp[key] = np.squeeze(np.asarray(value))

    def save_checkpoint(self, arrays: Dict[str, np.ndarray],
                        attrs: Dict[str, object]) -> None:
        """Overwrite the single ``checkpoint`` group with the full solver
        state. Only the latest checkpoint is kept."""
        f = self.output_file
        if "checkpoint" in f:
            del f["checkpoint"]
        grp = f.create_group("checkpoint")
        for key, value in arrays.items():
            grp[key] = np.asarray(value)
        for key, value in attrs.items():
            grp.attrs[key] = value
        # Flush so the checkpoint survives a hard kill (preemption/crash).
        f.flush()


class RunningState:
    """Per-step scalar buffer between snapshots (cf. reference
    ``runner.py:186-221``). Shapes are ``(size, buffer_size)``."""

    def __init__(self, names_and_sizes: Dict[str, int], buffer_size: int):
        self.buffer_size = buffer_size
        self.names_and_sizes = names_and_sizes
        self.values = {
            name: np.zeros((size, buffer_size))
            for name, size in names_and_sizes.items()
        }

    def clear(self) -> None:
        self._cursor = 0
        for name, size in self.names_and_sizes.items():
            self.values[name] = np.zeros((size, self.buffer_size))

    def append_outputs(self, outputs: StepOutputs, n_valid: int) -> None:
        """Append one chunk's stacked step outputs (host arrays) at the
        write cursor (chunks may be smaller than the save interval)."""
        start = getattr(self, "_cursor", 0)
        stop = min(start + n_valid, self.buffer_size)
        m = stop - start
        self.values["dt"][0, start:stop] = np.asarray(outputs.dt)[:m]
        if "mu" in self.values:
            self.values["mu"][:, start:stop] = (
                np.asarray(outputs.mu_probe)[:m].T
            )
            self.values["theta"][:, start:stop] = (
                np.asarray(outputs.theta_probe)[:m].T
            )
        if "screening_iterations" in self.values:
            self.values["screening_iterations"][0, start:stop] = (
                np.asarray(outputs.screening_iterations)[:m]
            )
        self._cursor = stop


class Runner:
    """Drives the two solve stages (thermalize, simulate) chunk by chunk.

    Args:
        chunk_fn: ``state -> (state, outputs, exported)``, advancing up to
            ``chunk_size`` steps on the device.
        initial_state: The device-resident state.
        options: Solver options.
        data_handler: Output file handler.
        state_to_arrays: Maps an exported-state dict to the dict of arrays
            saved in each snapshot.
        running_names_and_sizes: Names/sizes of the per-step scalars.
        chunk_size: Steps per ``chunk_fn`` call.
        initial_export: Host view of the initial state (the step-0
            snapshot).
        checkpoint_meta: Attributes of every checkpoint.
        host_update_fn: Optional ``state -> state`` called before every
            chunk (the host-evaluated time-dependent inputs; the solver
            sets the chunk size to 1 then).
        resume: The initial state is a checkpoint's: skip thermalization
            (``skip_time`` is ignored with a warning).
        monitor: After the step-0 snapshot, start ``python -m
            tdgl_tpu_torch.visualize --input <output> monitor`` in its own
            session, polling the side file every
            ``monitor_update_interval`` seconds.
    """

    def __init__(
        self,
        chunk_fn: Callable,
        initial_state,
        options: SolverOptions,
        data_handler: DataHandler,
        state_to_arrays: Callable[[Dict[str, np.ndarray]],
                                  Dict[str, np.ndarray]],
        running_names_and_sizes: Dict[str, int],
        chunk_size: int,
        initial_export: Dict[str, np.ndarray],
        checkpoint_meta: Dict[str, object],
        logger: Optional[logging.Logger] = None,
        host_update_fn: Optional[Callable] = None,
        resume: bool = False,
        monitor: bool = False,
        monitor_update_interval: float = 1.0,
    ):
        self.chunk_fn = chunk_fn
        self.state = initial_state
        self.options = options
        self.data_handler = data_handler
        self.state_to_arrays = state_to_arrays
        self.chunk_size = chunk_size
        # Host view of the latest state (updated after every chunk); the
        # initial value is built host-side so no device work is needed
        # before the first chunk.
        self._last_export = initial_export
        self.checkpoint_meta = checkpoint_meta
        self.host_update_fn = host_update_fn
        self.resume = resume
        self.monitor = monitor
        self.monitor_update_interval = monitor_update_interval
        self.logger = logger or logging.getLogger(__name__)
        self.running_state = RunningState(
            running_names_and_sizes, options.save_every
        )

    def run(self) -> bool:
        """Run thermalization (if any) then the recorded stage.

        Returns True if data was generated (i.e., the run was not cancelled
        during thermalization).
        """
        profile_dir = self.options.profile_dir
        if not profile_dir:
            return self._run_stages()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            result = self._run_stages()
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        return result

    def _run_stages(self) -> bool:
        options = self.options
        if options.skip_time and self.resume:
            self.logger.warning(
                "skip_time is ignored when resuming from a checkpoint"
                " (the checkpointed run already thermalized)."
            )
        if options.skip_time and not self.resume:
            ok = self._run_stage("Thermalizing", options.skip_time,
                                 save=False)
            if not ok:
                return False
            # Reset the clock and step counter; the adaptive tentative_dt
            # carries over (as in the reference, ``runner.py:315-318``).
            st = self.state
            self.state = st._replace(
                time=torch.zeros_like(st.time),
                step=torch.zeros_like(st.step),
                prev_dt=torch.full_like(st.prev_dt, options.dt_init),
                done=torch.zeros_like(st.done),
            )
            # Patch the host view's scalar diagnostics to the reset values.
            diag = np.array(self._last_export["diagnostics"])
            diag[0] = 0.0           # time
            diag[1] = options.dt_init  # prev_dt
            diag[3] = 0.0           # step
            diag[4] = 0.0           # done
            self._last_export = dict(self._last_export, diagnostics=diag)
        self._run_stage("Simulating", options.solve_time, save=True)
        return True

    # -- internals -----------------------------------------------------------
    def _save_snapshot(self, running_state: Optional[Dict[str, np.ndarray]]
                       ) -> None:
        exported = dict(self._last_export)
        diag = exported.pop("diagnostics")
        attrs = dict(step=int(diag[3]), time=float(diag[0]),
                     dt=float(diag[1]))
        self.data_handler.save_time_step(
            attrs, self.state_to_arrays(exported), running_state
        )

    def _save_checkpoint(self) -> None:
        """Fetch the full device state and overwrite the file's single
        ``checkpoint`` group. 0-d fields (time, step, dts, flags) go to
        attrs; arrays to datasets."""
        if not self.options.save_checkpoints:
            return
        arrays, attrs = {}, dict(self.checkpoint_meta)
        for name, value in self.state._asdict().items():
            value = to_host(value)
            if value.ndim == 0:
                attrs[name] = value.item()
            else:
                arrays[name] = value
        self.data_handler.save_checkpoint(arrays, attrs)

    def _start_monitor(self) -> None:
        if not self.monitor:
            return
        cmd = [
            sys.executable, "-m", "tdgl_tpu_torch.visualize",
            "--input", self.data_handler.output_path,
            "monitor", "--interval", str(self.monitor_update_interval),
        ]
        subprocess.Popen(cmd, start_new_session=True)

    def _progress_bar(self, name: str, end_time: float):
        """A tqdm bar where tqdm is installed and log-based progress is
        off; else None (progress goes through the logger)."""
        if self.options.progress_interval > 0:
            return None
        try:
            from tqdm import tqdm
        except ImportError:
            return None
        return tqdm(total=float(end_time), desc=name, unit="tau",
                    dynamic_ncols=True)

    def _run_stage(self, name: str, end_time: float, save: bool) -> bool:
        options = self.options
        st = self.state
        self.state = st._replace(
            end_time=torch.full_like(st.time, end_time),
            done=torch.zeros_like(st.done),
        )
        cancelled = False
        last_report = _time.perf_counter()
        steps_at_report = 0
        pbar = self._progress_bar(name, end_time)
        with pbar if pbar is not None else contextlib.nullcontext():
            if save:
                self._save_snapshot(None)  # step-0 snapshot, no running state
                self._start_monitor()
            prev_time = 0.0
            while True:
                try:
                    if self.host_update_fn is not None:
                        self.state = self.host_update_fn(self.state)
                    self.state, outputs, exported = self.chunk_fn(self.state)
                    # The chunk's one read from the device.
                    outputs = StepOutputs(*(to_host(t) for t in outputs))
                    self._last_export = {k: to_host(v)
                                         for k, v in exported.items()}
                    n_valid = int(np.sum(outputs.valid))
                    diag = self._last_export["diagnostics"]
                    if bool(diag[5]):
                        raise RuntimeError(
                            f"Solver failed to converge at step"
                            f" {int(diag[3])} of stage"
                            f" {name!r}: the time step underflowed"
                            f" ({options.max_solve_retries} retries) or the"
                            " screening iteration hit"
                            f" {options.max_iterations_per_step} iterations."
                            " Try a smaller dt_init."
                        )
                    now = float(diag[0])
                    step_now = int(diag[3])
                    if pbar is not None:
                        pbar.update(min(now, end_time)
                                    - min(prev_time, end_time))
                    else:
                        t = _time.perf_counter()
                        rate = (step_now - steps_at_report) / max(
                            t - last_report, 1e-9
                        )
                        last_report, steps_at_report = t, step_now
                        self.logger.info(
                            f"{name}: Time {now:.3f}/{end_time},"
                            f" {rate:.2f} it/s"
                        )
                    prev_time = now
                    done = bool(diag[4])
                    if save and n_valid:
                        self.running_state.append_outputs(outputs, n_valid)
                    at_boundary = (step_now % options.save_every) == 0
                    if save and n_valid and (at_boundary or done
                                             or n_valid < self.chunk_size):
                        self._save_snapshot(dict(self.running_state.values))
                        self.running_state.clear()
                        self._save_checkpoint()
                    if done or n_valid < self.chunk_size:
                        break
                except KeyboardInterrupt:
                    step_now = (int(self._last_export["diagnostics"][3])
                                if self._last_export is not None else -1)
                    msg = f"{{}} simulation at step {step_now} of stage {name!r}."
                    if options.pause_on_interrupt:
                        response = input(
                            f"Simulation paused at stage {name!r}"
                            f" (step {step_now}). Continue? [yN]"
                        )
                        if response.lower().startswith("y"):
                            self.logger.info(msg.format("Resuming"))
                            continue
                    self.logger.warning(msg.format("Cancelling"))
                    cancelled = True
                    break
        return not cancelled
