"""Matplotlib perspective-field renderer (host-side numpy).

Port of perspectivefields_tpu/utils/visualizer.py (reference
perspective2d/utils/visualizer.py:10-279): quiver arrows for the up-vector
field and a 20-band seismic-colormap contour blend for latitude, drawn into
an Agg figure sized 1:1 with the image so get_image() returns an (H, W, 3)
uint8 RGB array. matplotlib is imported where it is used, so the package
imports without it.
"""

from __future__ import annotations

import numpy as np


class VisImage:
    """A figure/canvas pair pinned to image pixel coordinates."""

    def __init__(self, img: np.ndarray, scale: float = 1.0):
        import matplotlib.figure as mplfigure
        from matplotlib.backends.backend_agg import FigureCanvasAgg

        self.img = img
        self.scale = scale
        self.height, self.width = img.shape[0], img.shape[1]
        fig = mplfigure.Figure(frameon=False)
        self.dpi = fig.get_dpi()
        # tiny epsilon avoids matplotlib size truncation
        fig.set_size_inches(
            (self.width * scale + 1e-2) / self.dpi,
            (self.height * scale + 1e-2) / self.dpi,
        )
        self.canvas = FigureCanvasAgg(fig)
        ax = fig.add_axes([0.0, 0.0, 1.0, 1.0])
        ax.axis("off")
        ax.imshow(
            img.astype("uint8"),
            extent=(0, self.width, self.height, 0),
            interpolation="nearest",
        )
        self.fig = fig
        self.ax = ax

    def save(self, filepath: str):
        self.fig.savefig(filepath)

    def get_image(self) -> np.ndarray:
        s, (width, height) = self.canvas.print_to_buffer()
        buffer = np.frombuffer(s, dtype="uint8")
        img_rgba = buffer.reshape(height, width, 4)
        return img_rgba[:, :, :3].astype("uint8")


class VisualizerPerspective:
    """Draws up-vector arrows and latitude contour bands on an RGB image."""

    def __init__(self, img_rgb: np.ndarray, scale: float = 1.0):
        self.img = np.asarray(img_rgb).clip(0, 255).astype(np.uint8)
        self.output = VisImage(self.img, scale=scale)
        self._default_font_size = max(
            np.sqrt(self.img.shape[0] * self.img.shape[1]) // 90, 10 // scale
        )

    def draw_arrow(
        self, x_pos, y_pos, x_direct, y_direct, color=None, linewidth=None
    ) -> VisImage:
        """Quiver in pixel units; y_direct is in image-up convention (the
        caller negates the v-component)."""
        if linewidth is None:
            linewidth = self._default_font_size / 3
        linewidth = max(linewidth, 1)
        self.output.ax.quiver(
            x_pos,
            y_pos,
            x_direct,
            y_direct,
            color=color,
            scale_units="xy",
            scale=1,
            antialiased=True,
            headaxislength=3.5,
            linewidths=0.1,
        )
        return self.output

    def draw_text(
        self,
        text,
        position,
        *,
        font_size=None,
        color="g",
        horizontal_alignment="center",
        rotation=0,
    ) -> VisImage:
        """Label text on a dark box (reference: visualizer.py:137-185)."""
        import matplotlib.colors as mplc

        if not font_size:
            font_size = self._default_font_size
        # text sits on a dark background: brighten dark colors
        color = np.maximum(list(mplc.to_rgb(color)), 0.2)
        color[np.argmax(color)] = max(0.8, np.max(color))
        x, y = position
        self.output.ax.text(
            x,
            y,
            text,
            size=font_size * self.output.scale,
            family="sans-serif",
            bbox={"facecolor": "black", "alpha": 0.8, "pad": 0.7, "edgecolor": "none"},
            verticalalignment="top",
            horizontalalignment=horizontal_alignment,
            color=color,
            zorder=10,
            rotation=rotation,
        )
        return self.output

    def draw_box(self, box_coord, alpha=0.5, edge_color="g", line_style="-") -> VisImage:
        """Axis-aligned box (x0, y0, x1, y1) in pixel coords."""
        import matplotlib as mpl

        x0, y0, x1, y1 = box_coord
        linewidth = max(self._default_font_size / 4, 1)
        self.output.ax.add_patch(
            mpl.patches.Rectangle(
                (x0, y0),
                x1 - x0,
                y1 - y0,
                fill=False,
                edgecolor=edge_color,
                linewidth=linewidth * self.output.scale,
                alpha=alpha,
                linestyle=line_style,
            )
        )
        return self.output

    def draw_circle(self, circle_coord, color, radius=3) -> VisImage:
        import matplotlib as mpl

        x, y = circle_coord
        self.output.ax.add_patch(
            mpl.patches.Circle(circle_coord, radius=radius, fill=True, color=color)
        )
        return self.output

    def draw_line(self, x_data, y_data, color, linestyle="-", linewidth=None) -> VisImage:
        import matplotlib as mpl

        if linewidth is None:
            linewidth = self._default_font_size / 3
        linewidth = max(linewidth, 1)
        self.output.ax.add_line(
            mpl.lines.Line2D(
                x_data,
                y_data,
                linewidth=linewidth * self.output.scale,
                color=color,
                linestyle=linestyle,
            )
        )
        return self.output

    def get_output(self) -> VisImage:
        return self.output

    def draw_lati(
        self,
        latimap: np.ndarray,
        alpha_contourf: float = 0.4,
        alpha_contour: float = 0.9,
        contour_only: bool = False,
    ) -> VisImage:
        """Blend a latitude map (radians, (H, W)) as filled + line contours,
        20 seismic bands over [-pi/2, pi/2]."""
        import matplotlib.pyplot as plt

        latimap = np.asarray(latimap)
        height, width = latimap.shape
        y, x = np.mgrid[0:height, 0:width]
        cmap = plt.get_cmap("seismic")
        levels = np.linspace(-np.pi / 2, np.pi / 2, 19)
        if contour_only:
            self.output.ax.contour(
                x, y, latimap, levels=[0], cmap=cmap,
                alpha=alpha_contour, antialiased=True, linewidths=15,
            )
            return self.output
        filled = self.output.ax.contourf(
            x, y, latimap, levels=levels, cmap=cmap,
            alpha=alpha_contourf, antialiased=True,
        )
        lines = self.output.ax.contour(
            x, y, latimap, filled.levels, cmap=cmap,
            alpha=alpha_contour, antialiased=True, linewidths=5,
        )
        try:
            lines.set_linestyle("solid")
        except AttributeError:  # older matplotlib exposes per-collection styles
            for c in lines.collections:
                c.set_linestyle("solid")
        return self.output
