"""GSFSignature demo drivers — the port of
`wittgenstein_tpu/scenarios/gsf_scenarios.py`: `sigs_per_time`
(GSFSignature.sigsPerTime: min/avg/max verified-set cardinality sampled
over time, as CSV and a PNG, which needs matplotlib) and `draw_imgs`
(GSFSignature.drawImgs: a world-map animation colored by signature
count, which needs PIL).  Each takes ``device=`` (``cuda`` unless the
caller asks for another).

Run ``python -m wittgenstein_tpu_torch.scenarios.gsf_scenarios
[out_dir]`` for a smoke pass of both on the card.
"""

from __future__ import annotations

from ..core.network import Runner
from ..models.gsf import GSFSignature
from ..ops import bitset
from ..tools.csvf import CSVFormatter
from ..tools.graph import Graph, Series


def sigs_per_time(nodes=128, nodes_down=0, max_time=3000, stat_each_ms=10,
                  seed=0, out_dir=".", *, device=None):
    """Verified-signature counts over time (wittgenstein_tpu/scenarios/
    gsf_scenarios.py:22-54): min/avg/max of |V| over live nodes every
    `stat_each_ms`, until every live node holds the full set."""
    proto = GSFSignature(node_count=nodes, nodes_down=nodes_down,
                         device=device)
    runner = Runner(proto)
    net, ps = proto.init(seed)
    down = net.nodes.down.cpu().numpy()
    csv = CSVFormatter(["time_ms", "min", "avg", "max"])
    g = Graph(f"GSFSignature sigs over time, n={nodes}", "time (ms)",
              "verified sigs")
    s_min, s_avg, s_max = (Series("min"), Series("avg"), Series("max"))
    t = 0
    while t < max_time:
        net, ps = runner.run_ms(net, ps, stat_each_ms)
        t += stat_each_ms
        card = bitset.popcount(ps.verified).cpu().numpy()[~down]
        csv.add(time_ms=t, min=int(card.min()),
                avg=round(float(card.mean()), 1), max=int(card.max()))
        s_min.add(t, int(card.min()))
        s_avg.add(t, float(card.mean()))
        s_max.add(t, int(card.max()))
        if card.min() >= nodes - int(down.sum()):
            break
    for s in (s_min, s_avg, s_max):
        g.add_series(s)
    csv.save(f"{out_dir}/gsf_sigs_per_time.csv")
    g.save(f"{out_dir}/gsf_sigs_per_time.png")
    return csv


def draw_imgs(nodes=128, out_path="gsf.gif", frames=30, frame_ms=25,
              seed=0, *, device=None):
    """World-map GIF colored by verified-set size (wittgenstein_tpu/
    scenarios/gsf_scenarios.py:57-70)."""
    from ..tools.node_drawer import NodeDrawer
    proto = GSFSignature(node_count=nodes, device=device)
    runner = Runner(proto)
    net, ps = proto.init(seed)
    drawer = NodeDrawer(vmin=1, vmax=nodes)
    for _ in range(frames):
        net, ps = runner.run_ms(net, ps, frame_ms)
        vals = bitset.popcount(ps.verified).cpu().numpy()
        drawer.draw(net.nodes, vals)
        down = net.nodes.down.cpu().numpy()
        if int(vals[~down].min()) >= nodes - int(down.sum()):
            break
    drawer.save_gif(out_path, ms_per_frame=100)
    return out_path


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "."
    sigs_per_time(nodes=64, out_dir=out)
    draw_imgs(nodes=64, out_path=f"{out}/gsf.gif")
