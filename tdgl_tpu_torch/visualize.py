"""Command-line visualization tool (the counterpart of
:mod:`tdgl_tpu.visualize`).

API parity with the reference ``tdgl/visualize.py:19-272``:
``python -m tdgl_tpu_torch.visualize --input <file>
{interactive,animate,monitor,convert,snapshot}``. ``convert`` needs only
numpy; the other commands draw with matplotlib.
"""

from __future__ import annotations

import argparse
import logging

from .visualization import (
    DEFAULT_QUANTITIES,
    InteractivePlot,
    MultiInteractivePlot,
    Quantity,
    convert_to_xdmf,
    create_animation,
    generate_snapshots,
    monitor_solution,
)

logger = logging.getLogger("visualize")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Visualize TDGL simulation data."
    )
    parser.add_argument("--input", "-i", type=str, required=True,
                        help="HDF5 file to visualize.")
    parser.add_argument("--output", "-o", type=str, default=None,
                        help="Output file path (animate/convert).")
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument(
        "--quantities",
        type=lambda s: str(s).upper(),
        choices=Quantity.get_keys() + ["ALL"],
        nargs="*",
        help="Quantities to display.",
    )
    parser.add_argument("--shading", type=str, default="gouraud",
                        choices=["flat", "gouraud"])
    parser.add_argument("--dimensionless", action="store_true",
                        help="Use dimensionless (xi-scaled) coordinates.")
    parser.add_argument("--autoscale", action="store_true",
                        help="Autoscale color limits per frame.")
    parser.add_argument("--axes-off", action="store_true")
    parser.add_argument("--title-off", action="store_true")
    parser.add_argument("--axis-labels", action="store_true")
    parser.add_argument("--figsize", type=float, nargs=2, default=None)
    parser.add_argument("--dpi", type=float, default=100)

    subparsers = parser.add_subparsers(dest="command", required=True)

    subparsers.add_parser("interactive",
                          help="Interactively browse saved frames.")

    animate = subparsers.add_parser("animate",
                                    help="Render frames to a video/gif.")
    animate.add_argument("--fps", type=int, default=30)
    animate.add_argument("--min-frame", type=int, default=0)
    animate.add_argument("--max-frame", type=int, default=-1)

    monitor = subparsers.add_parser(
        "monitor", help="Live-monitor a running simulation."
    )
    monitor.add_argument("--interval", type=float, default=1.0,
                         help="Update interval in seconds.")

    convert = subparsers.add_parser(
        "convert", help="Convert the output to an XDMF time series."
    )
    convert.add_argument("--format", type=str, default="xdmf",
                         choices=["xdmf"])

    snapshot = subparsers.add_parser(
        "snapshot", help="Static figures at given times."
    )
    snapshot.add_argument("--times", "-t", type=float, nargs="+",
                          required=True)
    return parser


def _quantities(args):
    if args.quantities is None:
        return list(DEFAULT_QUANTITIES)
    if "ALL" in args.quantities:
        return Quantity.get_keys()
    return args.quantities


def visualize_tdgl(args) -> None:
    figure_kwargs = {}
    if args.figsize is not None:
        figure_kwargs["figsize"] = tuple(args.figsize)
    quantities = _quantities(args)
    if args.quantities is None and args.command == "interactive":
        InteractivePlot(
            input_file=args.input,
            shading=args.shading,
            dimensionless=args.dimensionless,
            figure_kwargs=figure_kwargs,
        ).show()
        return
    MultiInteractivePlot(
        input_file=args.input,
        shading=args.shading,
        dimensionless=args.dimensionless,
        quantities=quantities,
        figure_kwargs=figure_kwargs,
    ).show()


def animate_tdgl(args) -> None:
    figure_kwargs = {}
    if args.figsize is not None:
        figure_kwargs["figsize"] = tuple(args.figsize)
    output = args.output or (args.input.replace(".h5", "") + ".gif")
    create_animation(
        args.input,
        output_file=output,
        quantities=_quantities(args),
        shading=args.shading,
        fps=args.fps,
        dpi=args.dpi,
        min_frame=args.min_frame,
        max_frame=args.max_frame,
        autoscale=args.autoscale,
        dimensionless=args.dimensionless,
        axis_labels=args.axis_labels,
        axes_off=args.axes_off,
        title_off=args.title_off,
        figure_kwargs=figure_kwargs,
    )


def monitor_tdgl(args) -> None:
    h5path = args.input
    if not h5path.endswith(".tmp"):
        h5path = h5path + ".tmp"
    monitor_solution(
        h5path,
        update_interval=args.interval,
        quantities=_quantities(args),
        shading=args.shading,
        dimensionless=args.dimensionless,
    )


def convert_tdgl(args) -> None:
    out = convert_to_xdmf(args.input, args.output,
                          dimensionless=args.dimensionless)
    logger.info("Wrote %s", out)


def snapshot_tdgl(args) -> None:
    import matplotlib.pyplot as plt

    figures = generate_snapshots(
        args.input,
        times=args.times,
        quantities=_quantities(args),
        shading=args.shading,
        dimensionless=args.dimensionless,
        axis_labels=args.axis_labels,
        axes_off=args.axes_off,
        title_off=args.title_off,
    )
    for time, (fig, _) in zip(args.times, figures):
        path = args.input.replace(".h5", "") + f"_t{time:.1f}.png"
        fig.savefig(path, dpi=args.dpi)
        plt.close(fig)
        logger.info("Wrote %s", path)


def main(args=None) -> None:
    parser = make_parser()
    args = parser.parse_args(args)
    if args.verbose:
        logging.basicConfig(level=logging.INFO)
    dispatch = {
        "interactive": visualize_tdgl,
        "animate": animate_tdgl,
        "monitor": monitor_tdgl,
        "convert": convert_tdgl,
        "snapshot": snapshot_tdgl,
    }
    dispatch[args.command](args)


if __name__ == "__main__":
    main()
