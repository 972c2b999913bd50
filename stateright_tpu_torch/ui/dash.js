// Stateright pool dashboard — vanilla SPA, no build step (same style
// as app.js). Polls:
//   GET /.pool                      -> pool gauges + per-job snapshots
//   GET /.jobs/<id>/metrics.json?n= -> windowed metrics time-series rows
//   GET /.status                    -> fallback when no service is attached
// Renders stat tiles + single-series SVG sparklines (frontier size, gen/s
// derived from consecutive state_count deltas, queue depth from the poll
// ring). Status verdicts (breaker, heartbeat staleness) always carry a
// text label next to the colored dot — never color alone.

"use strict";

const POLL_MS = 2000;
const SERIES_N = 120;
const el = (id) => document.getElementById(id);

function escapeHtml(s) {
  return String(s).replace(/[&<>"']/g, (c) => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;",
  })[c]);
}

function fmt(v) {
  if (v === null || v === undefined) return "–";
  if (typeof v !== "number") return String(v);
  if (Math.abs(v) >= 1e6) return (v / 1e6).toFixed(2) + "M";
  if (Math.abs(v) >= 1e4) return (v / 1e3).toFixed(1) + "k";
  if (Number.isInteger(v)) return v.toLocaleString();
  return v.toFixed(2);
}

function ageLabel(s) {
  if (s === null || s === undefined) return "–";
  return s < 90 ? `${Math.round(s)}s ago` : `${Math.round(s / 60)}m ago`;
}

// --- sparkline -------------------------------------------------------------

// Single-series sparkline (no legend — the row's name labels it): 2px
// line in the series hue, a 3px end-dot, and a hover layer that snaps to
// the nearest sample and shows its value in the readout span.
function sparkline(container, values, fmtVal) {
  const W = 170, H = 36, PAD = 3;
  fmtVal = fmtVal || fmt;
  const svgNS = "http://www.w3.org/2000/svg";
  container.innerHTML = "";
  const svg = document.createElementNS(svgNS, "svg");
  svg.setAttribute("width", W);
  svg.setAttribute("height", H);
  const readout = container.parentElement.querySelector(".val");
  if (!values.length) {
    if (readout) readout.textContent = "–";
    container.appendChild(svg);
    return;
  }
  const lo = Math.min(...values), hi = Math.max(...values);
  const span = hi - lo || 1;
  const x = (i) => values.length === 1
    ? W / 2 : PAD + (i * (W - 2 * PAD)) / (values.length - 1);
  const y = (v) => H - PAD - ((v - lo) * (H - 2 * PAD)) / span;
  const line = document.createElementNS(svgNS, "polyline");
  line.setAttribute("points", values.map((v, i) => `${x(i)},${y(v)}`).join(" "));
  line.setAttribute("fill", "none");
  line.setAttribute("stroke", "var(--series-1)");
  line.setAttribute("stroke-width", "2");
  line.setAttribute("stroke-linejoin", "round");
  svg.appendChild(line);
  const dot = document.createElementNS(svgNS, "circle");
  dot.setAttribute("r", "3");
  dot.setAttribute("fill", "var(--series-1)");
  dot.setAttribute("cx", x(values.length - 1));
  dot.setAttribute("cy", y(values[values.length - 1]));
  svg.appendChild(dot);
  const last = values[values.length - 1];
  if (readout) readout.textContent = fmtVal(last);
  // Hover layer: nearest-sample readout (reverts to the latest value on
  // leave); the whole svg is the hit target, larger than any mark.
  svg.addEventListener("mousemove", (e) => {
    const rect = svg.getBoundingClientRect();
    const i = Math.max(0, Math.min(values.length - 1,
      Math.round(((e.clientX - rect.left - PAD) / (W - 2 * PAD)) * (values.length - 1))));
    dot.setAttribute("cx", x(i));
    dot.setAttribute("cy", y(values[i]));
    if (readout) readout.textContent = fmtVal(values[i]);
  });
  svg.addEventListener("mouseleave", () => {
    dot.setAttribute("cx", x(values.length - 1));
    dot.setAttribute("cy", y(last));
    if (readout) readout.textContent = fmtVal(last);
  });
  container.appendChild(svg);
}

function sparkRow(name) {
  const row = document.createElement("div");
  row.className = "spark";
  row.innerHTML = `<span class="name">${escapeHtml(name)}</span>` +
    `<span class="plot"></span><span class="val mono"></span>`;
  return row;
}

// --- pool header -----------------------------------------------------------

const queueRing = [];   // {t, queued, running} from each poll

function breakerBadge(b) {
  if (!b) return "";
  const open = b.state === "open";
  const cls = open ? "serious" : "good";
  const label = open
    ? `breaker OPEN (${b.consecutive_wedges}/${b.k} wedges)`
    : "breaker closed";
  return `<span class="badge ${cls}"><span class="dot"></span>${label}</span>`;
}

function hbBadge(age) {
  if (age === null || age === undefined)
    return `<span class="badge"><span class="dot"></span>no heartbeat</span>`;
  const cls = age < 30 ? "good" : age < 120 ? "warning" : "serious";
  const word = age < 30 ? "beating" : age < 120 ? "quiet" : "stale";
  return `<span class="badge ${cls}"><span class="dot"></span>heartbeat ${word} · ${ageLabel(age)}</span>`;
}

// QoS class tiles (docs/service.md "QoS & overload"): one tile per
// priority class with live queue/run occupancy and the fair-share
// weight, plus shed/quota counters when the overload tier has acted.
function qosTiles(pool) {
  const qos = pool.qos;
  if (!qos || !qos.classes) return "";
  let html = Object.keys(qos.classes).map((cls) => {
    const c = qos.classes[cls];
    return `<div class="tile"><div class="v">${fmt(c.queued)}+${fmt(c.running)}</div>` +
      `<div class="k">${escapeHtml(cls)} (w=${fmt(c.weight)})</div></div>`;
  }).join("");
  if (pool.sheds || pool.quota_rejects) {
    html += `<div class="tile"><div class="v">${fmt(pool.sheds || 0)}</div>` +
      `<div class="k">shed (${fmt(pool.quota_rejects || 0)} quota)</div></div>`;
  }
  return html;
}

function renderPool(pool) {
  const tiles = [
    ["queued", pool.queued], ["in flight", pool.running],
    ["quarantined", pool.quarantined], ["sessions", pool.interactive],
    ["done", pool.jobs_done], ["failed", pool.jobs_failed],
    ["wedges", pool.wedge_verdicts], ["requeues", pool.requeues],
  ];
  el("pool-tiles").innerHTML = tiles.map(([k, v]) =>
    `<div class="tile"><div class="v">${fmt(v)}</div><div class="k">${k}</div></div>`
  ).join("") + `<div class="tile"><div class="v">${breakerBadge(pool.breaker)}</div>` +
    `<div class="k">${pool.fleet ? "fleet" : "device"}</div></div>` +
    (pool.fleet ? `<div class="tile"><div class="v">${fmt(pool.migrations)}</div>` +
      `<div class="k">migrations</div></div>` : "") +
    // Lane occupancy (batched scheduling; docs/service.md): mean lanes
    // per mux group plus the device calls the batching avoided.
    (pool.mux_groups ? `<div class="tile"><div class="v">` +
      `${(pool.mux_lanes / pool.mux_groups).toFixed(1)}×</div>` +
      `<div class="k">lane occupancy (${fmt(pool.mux_groups)} batches · ` +
      `${fmt(pool.mux_dispatches_saved)} dispatches saved)</div></div>` : "") +
    (pool.journal ? `<div class="tile"><div class="v">${fmt(pool.journal.records)}</div>` +
      `<div class="k">journal records</div></div>` : "") +
    qosTiles(pool);

  queueRing.push({ queued: (pool.queued || 0) + (pool.quarantined || 0),
                   running: pool.running || 0 });
  if (queueRing.length > SERIES_N) queueRing.shift();
  let sparks = el("pool-sparks");
  if (!sparks.dataset.built) {
    sparks.dataset.built = "1";
    for (const name of ["queue depth", "in flight"]) {
      sparks.appendChild(sparkRow(name));
    }
  }
  const rows = sparks.querySelectorAll(".spark");
  sparkline(rows[0].querySelector(".plot"), queueRing.map((r) => r.queued));
  sparkline(rows[1].querySelector(".plot"), queueRing.map((r) => r.running));
}

// --- devices (fleet pools; service/fleet.py) -------------------------------

function deviceBadge(dev) {
  if (dev.lost)
    return `<span class="badge serious"><span class="dot"></span>LOST</span>`;
  // Elastic pools (docs/service.md "QoS & overload"): a quiesced pool
  // is healthy but parked — it wakes on queue pressure.
  if (dev.quiesced)
    return `<span class="badge"><span class="dot"></span>quiesced</span>`;
  const open = dev.breaker && dev.breaker.state === "open";
  return open
    ? `<span class="badge warning"><span class="dot"></span>breaker open</span>`
    : `<span class="badge good"><span class="dot"></span>healthy</span>`;
}

function renderDevices(devices) {
  const holder = el("devices");
  if (!holder) return;
  if (!devices) { holder.innerHTML = ""; return; }
  holder.innerHTML = Object.keys(devices).map((name) => {
    const d = devices[name];
    return `<div class="tile device"><h3><span class="mono">${escapeHtml(name)}</span>` +
      `${deviceBadge(d)}</h3>` +
      `<div class="meta mono">run ${fmt(d.running)} · queue ${fmt((d.queued || 0) + (d.quarantined || 0))}` +
      ` · done ${fmt(d.jobs_done)}` +
      (d.jobs_evacuated ? ` · evac ${fmt(d.jobs_evacuated)}` : "") +
      (d.wedge_verdicts ? ` · wedges ${fmt(d.wedge_verdicts)}` : "") +
      `</div></div>`;
  }).join("");
}

// --- jobs ------------------------------------------------------------------

function statusBadge(job) {
  const cls = job.status === "done" ? "good"
    : job.status === "failed" ? "serious"
    : job.status === "quarantined" ? "warning" : "";
  return `<span class="badge ${cls}"><span class="dot"></span>${escapeHtml(job.status)}</span>`;
}

function jobCard(id, job) {
  const div = document.createElement("div");
  div.className = "job";
  div.id = `job-${id}`;
  const engine = job.degraded ? `${job.engine} (degraded)` : job.engine;
  div.innerHTML =
    `<h3><span class="mono">${escapeHtml(id)}</span>${statusBadge(job)}</h3>` +
    `<div class="meta">${escapeHtml(job.spec || "")} · ${escapeHtml(engine || "")}` +
    ` · ${escapeHtml(job.kind || "batch")}` +
    // QoS identity: priority class (+ tenant when not the default).
    (job.priority && job.priority !== "batch" ? ` · ${escapeHtml(job.priority)}` : "") +
    (job.tenant && job.tenant !== "default" ? ` · ${escapeHtml(job.tenant)}` : "") +
    // Mux membership: the lane this member rode (rates on this card are
    // the LANE's own — the batch total lives in the pool tiles).
    (job.mux ? ` · lane ${(job.mux.lane || 0) + 1}/${job.mux.lanes}` +
      ` of ${escapeHtml(job.mux.group || "")}` : "") +
    (job.wedges ? ` · ${job.wedges} wedge${job.wedges > 1 ? "s" : ""}` : "") +
    (job.requeues ? ` · ${job.requeues} requeue${job.requeues > 1 ? "s" : ""}` : "") +
    `</div>` +
    `<div class="meta">${hbBadge(job.heartbeat_age_s)} ` +
    `<span class="badge"><span class="dot"></span>checkpoint ${ageLabel(job.checkpoint_age_s)}</span></div>` +
    (job.result ? `<div class="meta mono">generated ${fmt(job.result.generated)} · ` +
      `unique ${fmt(job.result.unique)} · depth ${fmt(job.result.max_depth)} · ` +
      `${fmt(job.result.seconds)}s</div>` : "") +
    (job.error ? `<div class="err">${escapeHtml(job.error)}</div>` : "") +
    `<div class="series"></div>`;
  return div;
}

async function renderJobSeries(id, card) {
  let doc;
  try {
    const res = await fetch(`/.jobs/${encodeURIComponent(id)}/metrics.json?n=${SERIES_N}`);
    if (!res.ok) return;  // host-engine job or swept artifacts: no series
    doc = await res.json();
  } catch (_err) { return; }
  const rows = (doc.rows || []).map((r) => r.metrics).filter(Boolean);
  if (!rows.length) return;
  const holder = card.querySelector(".series");
  if (!holder.dataset.built) {
    holder.dataset.built = "1";
    for (const name of ["frontier", "gen/s", "table occupancy"]) {
      holder.appendChild(sparkRow(name));
    }
  }
  const sparkEls = holder.querySelectorAll(".spark");
  sparkline(sparkEls[0].querySelector(".plot"), rows.map((m) => m.frontier_count || 0));
  // gen/s between consecutive samples: Δ generated / Δ wall-clock.
  const rates = [];
  const raw = doc.rows || [];
  for (let i = 1; i < raw.length; i++) {
    const ds = (raw[i].metrics.state_count || 0) - (raw[i - 1].metrics.state_count || 0);
    const dt = (raw[i].unix_ts || 0) - (raw[i - 1].unix_ts || 0);
    if (dt > 0 && ds >= 0) rates.push(ds / dt);
  }
  sparkline(sparkEls[1].querySelector(".plot"), rates);
  sparkline(sparkEls[2].querySelector(".plot"),
    rows.map((m) => m.table_occupancy || 0), (v) => (100 * v).toFixed(1) + "%");
}

function renderJobs(jobs) {
  const holder = el("jobs");
  const ids = Object.keys(jobs);
  if (!ids.length) {
    holder.innerHTML = '<div class="empty">No jobs in the pool yet.</div>';
    return;
  }
  if (holder.querySelector(".empty")) holder.innerHTML = "";
  for (const id of ids) {
    const job = jobs[id];
    const fresh = jobCard(id, job);
    const existing = el(`job-${id}`);
    if (existing) {
      // Preserve the built sparkline sub-tree across re-renders (its
      // hover state and data-built flag live in the DOM).
      const series = existing.querySelector(".series");
      fresh.querySelector(".series").replaceWith(series);
      existing.replaceWith(fresh);
    } else {
      holder.appendChild(fresh);
    }
    if (job.status === "running" || job.status === "done" ||
        job.kind === "interactive") {
      renderJobSeries(id, fresh);
    }
  }
}

// --- polling ---------------------------------------------------------------

async function poll() {
  try {
    const res = await fetch("/.pool");
    if (res.ok) {
      const pool = await res.json();
      el("pool-error").textContent = "";
      renderPool(pool);
      renderDevices(pool.devices || null);
      renderJobs(pool.jobs || {});
      return;
    }
    // No service attached: degrade to a single interactive card fed by
    // /.status + the live series ring.
    const st = await fetch("/.status");
    if (!st.ok) throw new Error(`status ${st.status}`);
    const s = await st.json();
    el("pool-tiles").innerHTML =
      `<div class="tile"><div class="v">${fmt(s.state_count)}</div><div class="k">states</div></div>` +
      `<div class="tile"><div class="v">${fmt(s.unique_state_count)}</div><div class="k">unique</div></div>` +
      `<div class="tile"><div class="v">${fmt(s.max_depth)}</div><div class="k">depth</div></div>`;
    renderJobs({ interactive: {
      kind: "interactive", spec: s.model, status: s.done ? "done" : "running",
      engine: (s.metrics || {}).engine, heartbeat_age_s: s.heartbeat_age_s,
      checkpoint_age_s: null,
    }});
  } catch (_err) {
    el("pool-error").textContent = "server unreachable — retrying";
  }
}

poll();
setInterval(poll, POLL_MS);
